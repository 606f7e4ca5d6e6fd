"""Median round wall time of the traced run's window, over the rounds
outside its profiled part."""
from ivos_bench.metrics._common import percentile, untraced_rounds


def read(run):
    return percentile([r.ms for r in untraced_rounds(run)], 50)
