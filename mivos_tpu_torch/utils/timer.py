"""Pausable wall-clock accumulator (counterpart of
mivos_tpu/utils/timer.py; reference interact/timer.py:3-33).

The GUI session keeps one for algorithm time and one for user time and
prints "[A: .., U: ..]" prefixes (reference interactive_gui.py:316-319).
"""
from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self._acc = 0.0
        self._paused = True
        self._last = 0.0

    def start(self) -> "Timer":
        if self._paused:
            self._last = time.perf_counter()
            self._paused = False
        return self

    def pause(self) -> "Timer":
        self.count()
        self._paused = True
        return self

    def count(self) -> float:
        if self._paused:
            return self._acc
        now = time.perf_counter()
        self._acc += now - self._last
        self._last = now
        return self._acc

    def format(self) -> str:
        return "%03.2f" % self.count()

    def __str__(self) -> str:
        return self.format()
