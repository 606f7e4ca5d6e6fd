"""Faults planted in the program under test, for the checks that
`correct` comes out false when the timed path is broken underneath.

`plant(name)` patches the program's classes for the duration of a
`with` block:

  state_unchanged       propagated frames keep the probabilities they
                        had: the step returns its state unchanged
  half_batch            the batched query encode computes the first half
                        of its frames and gives the rest the mean of
                        their features
  answer_altered        one propagated frame's probabilities (frame 2)
                        are replaced by the one-hot of their argmax where
                        the session stores them
  bank_commits_dropped  a pass commits its first propagated frame to the
                        bank and no later one: the bank stops growing
  half_objects          the readouts of the second half of the objects
                        are replaced by the mean of the first half's (no
                        cell catches it: PERF.md)
  interaction_altered   the cell's interaction (`interactions/`), where
                        it makes a mask on a frame the session has
                        already propagated, gives object 1's
                        probability to the background: an answer
                        altered where it is produced, whatever the
                        interaction

The exchange between chips has no fault here: every cell runs on one
chip.
"""
from __future__ import annotations

import contextlib
from typing import Iterator
from unittest import mock

import torch


def _state_unchanged():
    from mivos_tpu_torch.core.inference import InferenceCore

    def set_prob(self, ti, prob):
        if self.prob[ti] is None or ti in self.interacted:
            self.prob[ti] = prob
    return mock.patch.object(InferenceCore, "set_prob", set_prob)


def _half_batch():
    from mivos_tpu_torch.models.propagation import PropagationNetwork

    encode = PropagationNetwork.get_query_values_batched

    def encode_half(self, frames):
        half = max(1, frames.shape[0] // 2)
        feats = encode(self, frames[:half])
        return tuple(torch.cat([f, f.mean(0, keepdim=True).expand(
            frames.shape[0] - half, *f.shape[1:])]) for f in feats)
    return mock.patch.object(PropagationNetwork, "get_query_values_batched",
                             encode_half)


def _answer_altered():
    from mivos_tpu_torch.core.inference import InferenceCore

    set_prob = InferenceCore.set_prob

    def altered(self, ti, prob):
        if ti == 2 and ti not in self.interacted:
            prob = torch.nn.functional.one_hot(prob.argmax(0), prob.shape[0]).movedim(
                -1, 0).to(prob.dtype)
        set_prob(self, ti, prob)
    return mock.patch.object(InferenceCore, "set_prob", altered)


def _bank_commits_dropped():
    """The bank's count of committed slots stops one past the certain
    memory it was reset with: later commits are left out of every read."""
    from mivos_tpu_torch.core.memory_bank import MemoryBank

    reset = MemoryBank.reset

    def reset_once(self, *args, **kwargs):
        self.__dict__.pop("_most", None)
        reset(self, *args, **kwargs)
        self.__dict__["_most"] = self.num_slots + 1

    def set_slots(self, value):
        self.__dict__["_slots"] = min(value, self.__dict__.get("_most", value))

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(MemoryBank, "reset", reset_once))
    stack.enter_context(mock.patch.object(
        MemoryBank, "num_slots", property(lambda self: self.__dict__["_slots"], set_slots),
        create=True))
    return stack


def _half_objects():
    from mivos_tpu_torch.models.propagation import PropagationNetwork

    read_memory = PropagationNetwork.read_memory

    def read_half(self, *args, **kwargs):
        out = read_memory(self, *args, **kwargs)
        shards = out if isinstance(out, list) else [out]
        whole = torch.cat(shards)
        half = max(1, whole.shape[0] // 2)
        whole = torch.cat([whole[:half], whole[:half].mean(0, keepdim=True).expand(
            whole.shape[0] - half, *whole.shape[1:])])
        if not isinstance(out, list):
            return whole
        return list(whole.split([s.shape[0] for s in shards]))
    return mock.patch.object(PropagationNetwork, "read_memory", read_half)


class _Altered:
    def __init__(self, inner):
        self.inner = inner

    def round(self, frame_u8, labels, k, prob):
        mask, record = self.inner.round(frame_u8, labels, k, prob)
        if prob is not None:
            mask = mask.clone()
            mask[0] += mask[1]
            mask[1] = 0
        return mask, record


def _interaction_altered():
    from ivos_bench import interactions

    load = interactions.load

    def load_altered(name, root):
        mod = load(name, root)
        setup = mod.setup
        mod.setup = lambda cell, seed, dev: _Altered(setup(cell, seed, dev))
        return mod
    return mock.patch.object(interactions, "load", load_altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered,
          "bank_commits_dropped": _bank_commits_dropped,
          "half_objects": _half_objects,
          "interaction_altered": _interaction_altered}


@contextlib.contextmanager
def plant(name: str) -> Iterator[None]:
    with FAULTS[name]():
        yield
