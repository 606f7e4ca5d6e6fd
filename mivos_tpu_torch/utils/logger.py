"""Training logger, console only (counterpart of
mivos_tpu/utils/logger.py, whose TensorBoard writer degrades to the
console when TensorFlow is missing; reference util/logger.py): the
reference's console format, and the git branch and commit stamped at
start."""
from __future__ import annotations

import subprocess


def git_stamp() -> str:
    """'<branch> <sha>' of the working directory's repository, or
    'unknown' outside one."""
    try:
        out = [subprocess.run(cmd, capture_output=True, text=True, check=True,
                              timeout=10).stdout.strip()
               for cmd in (["git", "rev-parse", "--abbrev-ref", "HEAD"],
                           ["git", "rev-parse", "HEAD"])]
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return " ".join(out)


def _fix_width(x: float) -> str:
    return "{:.9s}".format("{:0.9f}".format(x))


class TensorboardLogger:
    """log_metrics / log_string in the reference's console format
    (util/logger.py:52-102). `short_id` "NULL" logs as DEBUG."""

    def __init__(self, short_id: str):
        self.short_id = "DEBUG" if short_id == "NULL" else short_id
        self.log_string("git", git_stamp())

    def log_metrics(self, l1: str, l2: str, val: float, step: int) -> None:
        print("{:s} - It {:6d} [{:5s}] [{:13}]: {:s}".format(
            self.short_id, step, l1.upper(), l2, _fix_width(float(val))),
            flush=True)

    def log_string(self, tag: str, x: str) -> None:
        print(tag, x, flush=True)
