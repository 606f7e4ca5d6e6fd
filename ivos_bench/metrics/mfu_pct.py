"""The model's FLOPs in the traced part (towers by FlopCounterMode on the
reference networks, the read by its algorithm's count, each as often as
MiVOS's loop runs it for the frames handed over: `counts.Schedule`), over
the traced wall time, as a share of the card's peak in the
configuration's precision."""
from ivos_bench.counts import PEAK_FLOPS


def read(run):
    w = run.work
    if run.trace is None or w is None or not w.decode or run.trace.window_s <= 0:
        return None
    flops = w.flops(run.phase_flops, run.config["top_k"])
    return 100.0 * flops / (run.trace.window_s * PEAK_FLOPS[run.config["dtype"]])
