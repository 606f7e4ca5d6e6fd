"""The annotator hands over the frame's whole label mask (DAVIS-style
corrections from ground truth): the same mask on both sides, with no
weights and nothing to record."""
from __future__ import annotations

from ivos_bench.clips import interaction_mask


class Mask:
    def round(self, frame_u8, labels, k, prob):
        return interaction_mask(labels, k), None

    def replay(self, frame_u8, labels, k, record):
        return interaction_mask(labels, k)


def setup(cell, seed, dev):
    return Mask()


def reference(cell, seed, dev):
    return Mask()
