"""Device kernels in the traced part per propagated frame."""
from ivos_bench.metrics._common import traced_reads


def read(run):
    if run.trace is None or not traced_reads(run) or not run.trace.kernels:
        return None
    return run.trace.kernels / traced_reads(run)
