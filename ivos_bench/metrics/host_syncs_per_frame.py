"""Blocking CUDA runtime calls (stream, event or device synchronise)
made inside the program's own spans (in the harness's rounds all within
`mivos.interact`), per propagated frame (the program's `frames`
counter), over the profiled part: the program's tracing
(`program_trace.metrics`). Left out where the trace holds no blocking
call at all, as a trace without the runtime's calls would."""
from ivos_bench.program_trace import metrics


def read(run):
    return metrics(run.program).get("host_syncs_per_frame")
