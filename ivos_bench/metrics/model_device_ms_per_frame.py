"""Device ms a propagated frame under the model's spans: query encode
and pre-encode, decode, memorize, fuse."""
from ivos_bench.metrics._common import traced_reads
from ivos_bench.spans import MODEL_SPANS


def read(run):
    if run.trace is None or not traced_reads(run):
        return None
    s = sum(run.trace.span_device_s.get(name, 0.0) for name in MODEL_SPANS)
    return s * 1e3 / traced_reads(run)
