"""90th percentile of the time from the interact call to its first
chunk_cb (when the first masks can show), over the traced run's rounds
outside its profiled part."""
from ivos_bench.metrics._common import percentile, untraced_rounds


def read(run):
    return percentile([r.first_ms for r in untraced_rounds(run)
                       if r.first_ms is not None], 90)
