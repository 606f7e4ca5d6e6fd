"""`PropagationNetwork.memorize` as a replayed CUDA graph
(`mivos_tpu_torch/models/memorize_graph.py`).

CPU tests: the CPU, the meta device, autograd and FLOP counting keep
memorize eager and count no graph; the graphs' cache, with the capture
stubbed: one graph a signature, shared by a shallow copy of the net and
not by a deep copy, at most MAX_GRAPHS a net, captured anew when a
weight moves, and gone with the net.

Card tests (marked `cuda`, skipped without a card; on the card:
`python -m pytest tests/test_torch_memorize_graph.py --noconftest -q`):
a replay is bitwise equal to the eager call, its outputs survive the
next call, a cast of the weights recaptures, two threads on one net get
their own answers, and a fusion session's probabilities are the same
graphed and eager.
"""
import copy
import functools
import gc
import sys
import threading

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.models import memorize_graph as mg
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork, compute_others
from mivos_tpu_torch.utils import trace
from mivos_tpu_torch.utils.tensor import cast_params_bf16

GRAPH_COUNTERS = ("memorize_graph_replays", "memorize_graph_captures")


@functools.lru_cache(maxsize=None)
def _base_net(seed, dtype):
    return init_params(PropagationNetwork(dtype=dtype),
                       torch.Generator().manual_seed(seed)).eval()


def _net(seed=0, dtype=torch.float32):
    """A net of its own (a deep copy: no graph cached) with seeded weights."""
    return copy.deepcopy(_base_net(seed, dtype))


def _inputs(k, h, w, seed=0, device="cpu"):
    """A frame (h, w, 3) and soft masks (k, h, w, 1) laid out as the
    session lays them out: NCHW storage seen through NHWC views."""
    gen = torch.Generator().manual_seed(seed)
    frame = torch.randn(3, h, w, generator=gen).to(device).movedim(0, -1)
    masks = torch.rand(k, 1, h, w, generator=gen).to(device).movedim(1, -1)
    return frame, masks


@pytest.fixture
def counted():
    trace.enable()
    try:
        yield trace.counters
    finally:
        trace.disable()


# ----- the gate (CPU) -----

@pytest.mark.parametrize("mode", ["cpu", "cpu_grad", "cpu_flops", "meta"])
def test_cpu_meta_grad_and_flop_counting_stay_eager(mode, counted, monkeypatch):
    calls = []
    monkeypatch.setattr(mg, "run", lambda *a: calls.append(a))
    device = "meta" if mode == "meta" else "cpu"
    with torch.device(device):
        net = PropagationNetwork() if mode == "meta" else None
    net = net if net is not None else _net()
    frame, masks = _inputs(2, 32, 48, device=device)
    others = compute_others(masks)
    with torch.set_grad_enabled(mode == "cpu_grad"):
        want = net._memorize_eager(frame, masks, others)
        if mode == "cpu_flops":
            counter = FlopCounterMode(display=False)
            with counter:
                got = net.memorize(frame, masks, others)
            assert counter.get_total_flops() > 0
        else:
            got = net.memorize(frame, masks, others)
    assert not calls
    assert all(counted()[c] == 0 for c in GRAPH_COUNTERS)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.device.type == device
        if device == "cpu":
            assert torch.equal(a, b)
    if mode == "cpu_grad":
        assert got[0].requires_grad


def test_unobserved_only_without_autograd_and_dispatch_modes():
    with torch.no_grad():
        assert mg.unobserved()
        with FlopCounterMode(display=False):
            assert not mg.unobserved()
    with torch.inference_mode():
        assert mg.unobserved()
    with torch.enable_grad():
        assert not mg.unobserved()
    assert not mg.eligible(torch.zeros(1))


# ----- the cache, the capture stubbed (CPU) -----

class _FakeGraph:
    """What `_capture` returns, without a card: replays return a marker."""

    def __init__(self, eager, args, pointers):
        self.pointers = pointers
        self.shapes = [tuple(x.shape) for x in args]
        self.retired = False
        self.replays = 0

    def replay(self, args):
        if self.retired:
            return None
        self.replays += 1
        return ("replayed", self)

    def retire(self):
        self.retired = True


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(mg, "_capture", _FakeGraph)


def _graphs(net):
    return mg._nets[net.mask_rgb_encoder].graphs


def test_one_capture_then_replays(stub, counted):
    net = _net()
    frame, masks = _inputs(3, 32, 48)
    assert mg.run(net, frame, masks, None) is None
    for _ in range(3):
        tag, graph = mg.run(net, frame, masks, None)
        assert tag == "replayed"
    assert graph.replays == 3 and graph.shapes == [(32, 48, 3), (3, 32, 48, 1)]
    assert counted()["memorize_graph_captures"] == 1
    assert counted()["memorize_graph_replays"] == 3


def test_signature_keys_k_size_dtype_strides_and_others(stub, counted):
    net = _net()
    frame, masks = _inputs(3, 32, 48)
    variants = [
        (frame, masks, None),
        (frame, masks[:2], None),                                  # K
        _inputs(3, 48, 32) + (None,),                              # frame size
        (frame.double(), masks.double(), None),                    # dtype
        (frame.contiguous(), masks.contiguous(), None),            # strides
        (frame, masks, compute_others(masks)),                     # others given
    ]
    for i, (f, m, o) in enumerate(variants):
        assert mg.run(net, f, m, o) is None, i
        assert mg.run(net, f, m, o)[0] == "replayed", i
    assert counted()["memorize_graph_captures"] == len(variants)
    assert counted()["memorize_graph_replays"] == len(variants)


def test_bound_retires_least_recently_used(stub):
    net = _net()
    ins = [_inputs(k, 32, 48) for k in range(1, mg.MAX_GRAPHS + 2)]
    for f, m in ins[:mg.MAX_GRAPHS]:
        mg.run(net, f, m, None)
    first = next(iter(_graphs(net).values()))
    mg.run(net, *ins[0], None)   # K = 1 used again: K = 2 is now the oldest
    second = list(_graphs(net).values())[0]
    assert second.shapes[1][0] == 2
    mg.run(net, *ins[-1], None)
    graphs = _graphs(net)
    assert len(graphs) == mg.MAX_GRAPHS
    assert second.retired and second not in graphs.values()
    assert first in graphs.values() and not first.retired
    assert sorted(g.shapes[1][0] for g in graphs.values()) == [1, 3, 4, 5]


def test_moved_weights_recapture_in_place_loads_do_not(stub, counted):
    net = _net()
    frame, masks = _inputs(2, 32, 48)
    mg.run(net, frame, masks, None)
    _, graph = mg.run(net, frame, masks, None)

    net.load_state_dict(_net(seed=1).state_dict())   # in place: same pointers
    assert mg.run(net, frame, masks, None) == ("replayed", graph)

    cast_params_bf16(net)                            # new .data
    assert mg.run(net, frame, masks, None) is None
    assert graph.retired
    _, graph = mg.run(net, frame, masks, None)

    bn = net.mask_rgb_encoder.layer3[0].bn2          # a buffer replaced
    bn.running_var = bn.running_var.clone()
    assert mg.run(net, frame, masks, None) is None
    assert graph.retired and len(_graphs(net)) == 1
    assert counted()["memorize_graph_captures"] == 3


def test_shallow_copy_shares_deep_copy_starts_empty(stub):
    net = _net()
    frame, masks = _inputs(3, 32, 48)
    mg.run(net, frame, masks, None)
    shallow = copy.copy(net)
    shallow.top_k = 7   # what InferenceCore changes on its copy
    tag, graph = mg.run(shallow, frame, masks, None)
    assert tag == "replayed" and graph in _graphs(net).values()
    deep = copy.deepcopy(net)
    assert deep.mask_rgb_encoder not in mg._nets
    assert mg.run(deep, frame, masks, None) is None
    assert _graphs(deep) is not _graphs(net)


def test_graphs_go_with_the_net(stub):
    net = _net()
    mg.run(net, *_inputs(1, 32, 48), None)
    before = len(mg._nets)
    del net
    gc.collect()
    assert len(mg._nets) == before - 1


def test_threads_capture_each_signature_once(stub, counted):
    """Sixteen threads on one net over three signatures, with the
    interpreter switching threads often: each signature is captured
    once, and every call either replays or runs eagerly."""
    net = _net()
    ins = [_inputs(k, 32, 48) for k in (1, 2, 3)]
    calls, results, errors = 40, [], []

    def work(i):
        try:
            for j in range(calls):
                results.append(mg.run(net, *ins[(i + j) % 3], None))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    c = counted()
    assert c["memorize_graph_captures"] == 3 == len(_graphs(net))
    replays = sum(r is not None for r in results)
    assert len(results) == 16 * calls
    assert c["memorize_graph_replays"] == replays >= 16 * calls - 16 * 3


# ----- on the card -----

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_nets(card):
    nets = {}
    for dtype in (torch.float32, torch.bfloat16):
        net = _net(dtype=dtype).to(card)
        if dtype == torch.bfloat16:
            cast_params_bf16(net)
        nets[dtype] = net
    return nets


def _fresh(net):
    """`net` with no graph cached, so that a test counts its own captures."""
    graphs = mg._nets.pop(net.mask_rgb_encoder, None)
    for graph in [] if graphs is None else graphs.graphs.values():
        graph.retire()
    return net


def _card_inputs(card, k, h, w, seed, others):
    frame, masks = _inputs(k, h, w, seed=seed, device=card)
    return frame, masks, (compute_others(masks) * 0.5 if others else None)


@pytest.mark.cuda
@pytest.mark.parametrize("others", [False, True], ids=["own", "others"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("size", [(64, 96), (128, 224)], ids=["64x96", "128x224"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_replay_bitwise_equals_eager(card, card_nets, counted, k, size, dtype, others):
    net = _fresh(card_nets[dtype])
    first = _card_inputs(card, k, *size, 0, others)
    second = _card_inputs(card, k, *size, 1, others)
    with torch.no_grad():
        want1 = net._memorize_eager(*first)
        want2 = net._memorize_eager(*second)
        got1 = net.memorize(*first)      # captures; computed eagerly
        got2 = net.memorize(*second)     # replays
        got3 = net.memorize(*first)
    c = counted()
    assert (c["memorize_graph_captures"], c["memorize_graph_replays"]) == (1, 2)
    for got, want in ((got1, want1), (got2, want2), (got3, want1)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_outputs_do_not_alias_the_graph(card, card_nets, counted):
    net = _fresh(card_nets[torch.bfloat16])
    a, b = (_card_inputs(card, 3, 64, 96, s, False) for s in (2, 3))
    with torch.no_grad():
        net.memorize(*a)
        keys, values = net.memorize(*a)
        kept = keys.clone(), values.clone()
        later = net.memorize(*b)
    assert counted()["memorize_graph_replays"] == 2
    assert not torch.equal(later[0], kept[0])
    assert torch.equal(keys, kept[0]) and torch.equal(values, kept[1])


@pytest.mark.cuda
def test_cast_of_the_weights_recaptures(card, counted):
    net = _net().to(card)
    ins = _card_inputs(card, 2, 64, 96, 4, False)
    with torch.no_grad():
        net.memorize(*ins)
        net.memorize(*ins)
        cast_params_bf16(net)
        net.memorize(*ins)            # captured anew on the bf16 weights
        got = net.memorize(*ins)
        want = net._memorize_eager(*ins)
    c = counted()
    assert (c["memorize_graph_captures"], c["memorize_graph_replays"]) == (2, 2)
    assert got[0].dtype == torch.bfloat16
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_grad_and_flop_counting_stay_eager_on_the_card(card, card_nets, counted):
    net = card_nets[torch.float32]
    ins = _card_inputs(card, 2, 64, 96, 5, False)
    with torch.no_grad():
        want = net._memorize_eager(*ins)
        with FlopCounterMode(display=False):
            flops = net.memorize(*ins)
    with torch.enable_grad():
        grads = net.memorize(*ins)
    assert all(counted()[c] == 0 for c in GRAPH_COUNTERS)
    for got in (flops, grads):
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_two_threads_on_one_net_get_their_own_answers(card, card_nets, counted):
    """One thread on the default stream, one on a stream of its own, each
    memorizing its own frame many times on one shared net."""
    net = _fresh(card_nets[torch.bfloat16])
    ins = [_card_inputs(card, 3, 64, 96, s, False) for s in (6, 7)]
    with torch.no_grad():
        want = [net._memorize_eager(*x) for x in ins]
        net.memorize(*ins[0])          # capture before the threads start
    torch.cuda.synchronize()
    results, errors = [[], []], []

    def work(i):
        try:
            with torch.no_grad(), torch.cuda.stream(
                    torch.cuda.current_stream() if i == 0 else torch.cuda.Stream()):
                for _ in range(30):
                    results[i].append(net.memorize(*ins[i]))
                torch.cuda.current_stream().synchronize()
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    assert counted()["memorize_graph_replays"] == 60
    for got, w in zip(results, want):
        for keys, values in got:
            assert torch.equal(keys, w[0]) and torch.equal(values, w[1])


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["exact", "auto"])
def test_fusion_session_same_graphed_and_eager(card, backend, monkeypatch):
    """Three rounds of a K = 3 session with fusion, bf16, on the card:
    every frame's probabilities graphed equal those computed eagerly."""
    t, h, w, k = 10, 70, 100, 3
    gen = torch.Generator().manual_seed(8)
    prop = init_params(PropagationNetwork(top_k=20, read_backend=backend,
                                          dtype=torch.bfloat16), gen)
    fuse = init_params(FusionNet(dtype=torch.bfloat16), gen)
    rng = np.random.RandomState(8)
    images = rng.randint(0, 256, (t, h, w, 3)).astype(np.uint8)
    rounds = (4, 8, 0)
    masks = []
    for _ in rounds:
        labels = rng.randint(0, k + 1, (h, w))
        fg = (labels[None] == np.arange(1, k + 1)[:, None, None]).astype(np.float32)
        masks.append(np.concatenate([1.0 - fg.sum(0, keepdims=True), fg])[..., None])

    def session():
        core = InferenceCore(prop, fuse, images, k, device=card,
                             mem=MemoryConfig(top_k=20, mem_freq=2))
        for idx, mask in zip(rounds, masks):
            core.interact(mask, idx, chunk_cb=lambda *a: None)
        torch.cuda.synchronize()
        return [None if p is None else p.clone() for p in core.prob]

    trace.enable()
    try:
        graphed = session()
        c = trace.counters()
    finally:
        trace.disable()
    with monkeypatch.context() as m:
        m.setattr(mg, "eligible", lambda x: False)
        eager = session()
    for a, b in zip(graphed, eager):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    # The interaction's masks and a pass's lie in other strides: two
    # signatures, each captured once.
    assert 1 <= c["memorize_graph_captures"] <= 2
    assert c["memorize_graph_replays"] + c["memorize_graph_captures"] == c["memorize"]
