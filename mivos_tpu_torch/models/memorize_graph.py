"""`PropagationNetwork.memorize` replayed as one CUDA graph per input
signature.

The memory encoder launches about 630 kernels a call: the 5-channel
ResNet-50 to layer3, whose frozen batch norms refold their scale and
shift on every call, the key and value heads and the flatten. At K = 3
and 1/16 resolution most of them run for a few microseconds, less than
the host takes to launch them, so the card waits on the host. `run`
captures the whole call once per signature of its inputs and replays
it: each call copies its inputs into the graph's static buffers,
replays, and returns copies of the outputs. The copies never alias the
graph's buffers, which the next replay overwrites (a session keeps an
interacted frame's keys across later calls). The graph runs the same
kernels on the same shapes as the eager call, so the numbers are the
same.

The signature is what the call can observe of its inputs: the device,
and the shape, strides and dtype of each input given (object shards
give `others`, other callers do not). A net's graphs live in a module-level
`WeakKeyDictionary` keyed by its `mask_rgb_encoder`, so a shallow copy of
the net (which shares the weights) shares them, a deep copy starts
empty, and they go with the net. At most `MAX_GRAPHS` signatures a net
are kept, the least recently used retired first: each graph holds a
private memory pool. A graph is captured anew when a parameter or buffer
of the encoder or the heads has moved (a new `data_ptr`: after
`cast_params_bf16` or `.to(device)`); an in-place `load_state_dict`
keeps the pointers, and the graph reads the new values.

`eligible` decides whether `memorize` may take this path at all: CUDA
tensors, no autograd, no dispatch mode (`FlopCounterMode`, fake tensors)
and no capture under way. Otherwise `memorize` runs eagerly as before.
The first call of a signature captures and returns None, and the caller
computes that call eagerly.

Threads share prepared nets (serve), so one lock a graph covers its
copy-in, replay and copy-out, and a replay from another stream than the
last one's waits for that stream first. Counters (`utils/trace.py`):
`memorize_graph_captures` and `memorize_graph_replays`.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from mivos_tpu_torch.utils import trace

MAX_GRAPHS = 4
_WARMUP = 2   # eager calls on the capture stream before the capture


def unobserved() -> bool:
    """No autograd and no dispatch mode (a FLOP counter, fake tensors)
    sees the call: a replay would hide its operations from them."""
    return not torch.is_grad_enabled() and torch._C._len_torch_dispatch_stack() == 0


def eligible(x: torch.Tensor) -> bool:
    """Whether `memorize` on `x`'s device may replay a graph."""
    return (x.is_cuda and unobserved()
            and not torch.cuda.is_current_stream_capturing())


class _Graph:
    """One captured call: its static inputs and outputs, the weight
    pointers it was captured on, and the stream its last copies ran on."""

    def __init__(self, graph, inputs: List[torch.Tensor],
                 outputs: Tuple[torch.Tensor, ...], pointers: Tuple[int, ...],
                 stream):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.pointers, self.stream = pointers, stream
        self.lock = threading.Lock()
        self.retired = False

    def replay(self, args: List[torch.Tensor]) -> Optional[Tuple[torch.Tensor, ...]]:
        """Copies of the outputs for `args`; None once retired."""
        with self.lock:
            if self.retired:
                return None
            with torch.cuda.device(args[0].device):
                stream = torch.cuda.current_stream()
                if stream != self.stream:
                    stream.wait_stream(self.stream)
                    self.stream = stream
                for buf, x in zip(self.inputs, args):
                    buf.copy_(x)
                self.graph.replay()
                return tuple(o.clone() for o in self.outputs)

    def retire(self) -> None:
        """Stop replays and wait for the last one before the graph and
        its pool can go."""
        with self.lock:
            self.retired = True
            self.stream.synchronize()


def _capture(eager: Callable, args: List[torch.Tensor],
             pointers: Tuple[int, ...]) -> _Graph:
    """Warm `eager` up on a side stream, then capture it there
    (`torch.cuda.graph`'s pattern) on static copies of `args`."""
    dev = args[0].device
    with torch.cuda.device(dev), torch.inference_mode(False), torch.no_grad():
        inputs = [torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=dev)
                  for x in args]
        for buf, x in zip(inputs, args):
            buf.copy_(x)
        current, side = torch.cuda.current_stream(), torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                eager(*inputs)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: a server's other threads may launch meanwhile.
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            outputs = eager(*inputs)
    return _Graph(graph, inputs, outputs, pointers, current)


class _NetGraphs:
    """The graphs of one net's memory encoder, most recently used last,
    and the parameter and buffer dicts whose pointers a graph reads."""

    def __init__(self, net: nn.Module):
        self.lock = threading.Lock()
        self.graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self.tensors = [d for m in (net.mask_rgb_encoder, net.kv_m_f16)
                        for sub in m.modules() for d in (sub._parameters, sub._buffers)]

    def pointers(self) -> Tuple[int, ...]:
        return tuple([t.data_ptr() for d in self.tensors for t in d.values()
                      if t is not None])


_nets: "weakref.WeakKeyDictionary[nn.Module, _NetGraphs]" = weakref.WeakKeyDictionary()
_nets_lock = threading.Lock()


def _graphs_of(net: nn.Module) -> _NetGraphs:
    with _nets_lock:
        graphs = _nets.get(net.mask_rgb_encoder)
        if graphs is None:
            graphs = _nets[net.mask_rgb_encoder] = _NetGraphs(net)
        return graphs


def run(net: nn.Module, frame: torch.Tensor, masks: torch.Tensor,
        others: Optional[torch.Tensor]) -> Optional[Tuple[torch.Tensor, ...]]:
    """`net.memorize(frame, masks, others)` by replay, or None when this
    call captured its signature's graph or found it retired by another
    thread: the caller then computes the call eagerly."""
    args = [frame, masks] if others is None else [frame, masks, others]
    key = (frame.device,) + tuple((x.shape, x.stride(), x.dtype) for x in args)
    graphs = _graphs_of(net)
    pointers = graphs.pointers()
    with graphs.lock:
        graph = graphs.graphs.get(key)
        if graph is not None:
            graphs.graphs.move_to_end(key)
    if graph is not None and graph.pointers == pointers:
        out = graph.replay(args)
        if out is not None:
            trace.count("memorize_graph_replays")
        return out
    with graphs.lock:
        if graphs.graphs.get(key) is graph:   # not captured anew meanwhile
            stale = [] if graph is None else [graphs.graphs.pop(key)]
            while len(graphs.graphs) >= MAX_GRAPHS:
                stale.append(graphs.graphs.popitem(last=False)[1])
            for old in stale:
                old.retire()
            graphs.graphs[key] = _capture(net._memorize_eager, args, pointers)
            trace.count("memorize_graph_captures")
    return None
