"""Device ms under the read span per traced read (one a frame)."""
from ivos_bench.metrics._common import traced_reads


def read(run):
    if run.trace is None or not traced_reads(run):
        return None
    s = run.trace.span_device_s.get("read")
    return None if s is None else s * 1e3 / traced_reads(run)
