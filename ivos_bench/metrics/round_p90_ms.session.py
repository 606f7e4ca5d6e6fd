"""90th percentile of the rounds' wall time, from the interact call to
its return with the card synchronised, over the traced run's rounds
outside its profiled part."""
from ivos_bench.metrics._common import percentile, untraced_rounds


def read(run):
    return percentile([r.ms for r in untraced_rounds(run)], 90)
