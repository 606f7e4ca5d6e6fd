"""The memory read's least time (its algorithm's FLOPs at the bf16
tensor peak or its bytes at the HBM peak, the larger, summed over the
traced reads) over the device time under the read span."""
from ivos_bench.counts import read_least_s
from ivos_bench.metrics._common import traced_reads


def read(run):
    if run.trace is None or not traced_reads(run):
        return None
    device = run.trace.span_device_s.get("read", 0.0)
    if device <= 0:
        return None
    top_k = run.config["top_k"]
    least = sum(read_least_s(k, n, m, b, top_k) for k, n, m, b in run.counts.reads)
    return 100.0 * least / device
