"""Frames propagated in the window (handed over by chunk_cb before it
closed), over the window's wall time; session creation inside it, the
checked session's copies to host memory outside it."""


def read(run):
    return run.frames / run.seconds if run.frames else None
