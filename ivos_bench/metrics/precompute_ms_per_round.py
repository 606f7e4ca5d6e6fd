"""Device ms under the query pre-encode span (`_precompute_queries`) per
traced round; 0 where the traced rounds called it and it found every
frame cached."""


def read(run):
    if run.trace is None or not run.counts.rounds or not run.counts.calls.get("precompute"):
        return None
    return run.trace.span_device_s.get("precompute", 0.0) * 1e3 / run.counts.rounds
