"""The port's data-parallel training pieces on a world of 2 CPU ranks over
gloo, against one process on the whole batch.

One spawned process group (tests/torch_ddp_ranks.py::rank_checks, which
imports only torch and the port) runs every check; the ranks meet
through a FileStore in a temporary directory (parallel/ranks.py), and
every wait is bounded, so a dead rank fails the test.

  SyncBatchNorm   forward, the running statistics after two steps, and
                  the gradients, against the JAX SyncBatchNorm and
                  sync_batch_norm on the whole batch (float32 sums in
                  another order: 1e-5)
  DDP             two FusionTrainer steps at 2 samples a rank against
                  the one-process steps at 4 (which
                  tests/test_torch_train.py holds to JAX). The mean of the
                  ranks' gradients is the whole batch's gradient up to
                  float32 rounding; Adam turns a rounding difference into
                  at most 2 x lr only on entries whose gradient is within
                  rounding of zero, and none is here: weights within 1e-6
                  (lr 1e-4), losses averaged over the ranks within 1e-5
  Integrator      the cross-rank mean of each rank's means, hooks on each
                  rank's own sums
  ShardedSampler  the ranks' shards cover the epoch's order
and that the ranks import neither jax nor mivos_tpu. Without the process
group: a flax SyncBatchNorm's variables load into the port's module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_ranks as R
from mivos_tpu.models.layers import SyncBatchNorm as JSyncBatchNorm
from mivos_tpu.ops.syncbn import sync_batch_norm as j_sync_batch_norm
from mivos_tpu_torch.checkpoint.pth import attention_read_state_dict
from mivos_tpu_torch.data.loader import ShardedSampler
from mivos_tpu_torch.models.fusion import AttentionReadNetwork
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.parallel.ranks import run_ranks
from mivos_tpu_torch.train.trainer import FusionTrainer

WORLD = 2
BN_TOL = 1e-5
WEIGHT_ATOL, LOSS_RTOL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def attn_state():
    """A random-init reader's weights, made once for the ranks and the
    one-process trainer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield attention_read_state_dict(init_params(
            AttentionReadNetwork(), torch.Generator().manual_seed(7)))
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(attn_state):
    return run_ranks(R.rank_checks, WORLD, (attn_state,), timeout_s=240)


def _nhwc(x):
    return np.moveaxis(x, 1, -1)


def _nchw(x):
    return np.ascontiguousarray(np.moveaxis(x, -1, 1))


def test_sync_batch_norm_matches_jax_on_the_whole_batch(ranks):
    x, g, weight, bias = R.syncbn_inputs()
    xj, gj = jnp.asarray(_nhwc(x)), jnp.asarray(_nhwc(g))
    bn = JSyncBatchNorm(x.shape[1])
    variables = bn.init(jax.random.PRNGKey(0), xj)
    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}
    stats = variables["batch_stats"]
    for _ in range(R.BN_STEPS - 1):
        _, upd = bn.apply({"params": params, "batch_stats": stats}, xj,
                          train=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]

    def loss(p, xx):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, xx, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(y * gj), (y, upd["batch_stats"])

    (_, (y, stats)), (dp, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, xj)
    # The functional form agrees with the module.
    y_fn, _ = j_sync_batch_norm(xj, params["scale"], params["bias"])
    np.testing.assert_allclose(np.asarray(y_fn), np.asarray(y), atol=1e-6)

    cat = lambda key: np.concatenate([r[key] for r in ranks])  # noqa: E731
    np.testing.assert_allclose(cat("bn_y"), np.moveaxis(np.asarray(y), -1, 1),
                               atol=BN_TOL)
    np.testing.assert_allclose(cat("bn_dx"), np.moveaxis(np.asarray(dx), -1, 1),
                               atol=BN_TOL)
    np.testing.assert_allclose(sum(r["bn_dweight"] for r in ranks),
                               np.asarray(dp["scale"]), atol=BN_TOL, rtol=BN_TOL)
    np.testing.assert_allclose(sum(r["bn_dbias"] for r in ranks),
                               np.asarray(dp["bias"]), atol=BN_TOL, rtol=BN_TOL)
    for r in ranks:   # every rank keeps the same running statistics
        np.testing.assert_allclose(r["bn_running"][0], np.asarray(stats["mean"]),
                                   atol=BN_TOL)
        np.testing.assert_allclose(r["bn_running"][1], np.asarray(stats["var"]),
                                   atol=BN_TOL)


def test_ddp_steps_match_one_process_on_the_whole_batch(ranks, attn_state):
    assert [r["ddp"] for r in ranks] == ["DistributedDataParallel"] * WORLD
    trainer = FusionTrainer(R.train_config(), attn_state, device="cpu")
    assert trainer.model is trainer.fuse_net   # no process group here
    init = {k: v.clone() for k, v in trainer.fuse_net.state_dict().items()}
    losses = [float(trainer.train_step(R.train_batch(s))["total_loss"])
              for s in range(R.TRAIN_STEPS)]
    moved = 0.0
    for k, v in trainer.fuse_net.state_dict().items():
        for r in ranks:
            np.testing.assert_allclose(r["weights"][k], v.numpy(), rtol=0,
                                       atol=WEIGHT_ATOL, err_msg=k)
        moved = max(moved, float((v - init[k]).abs().max()))
    assert moved > 1e-4   # the steps really moved the weights
    # The integrator's mean over steps and ranks of each rank's
    # half-batch loss is the mean of the whole-batch losses.
    for r in ranks:
        assert r["loss_mean"] == pytest.approx(np.mean(losses), rel=LOSS_RTOL)


def test_integrator_cross_rank_mean(ranks):
    # Rank r: a = (r, r + 2) -> mean r + 1; c = (sum hide_b) + (sum a)
    # on the rank's own sums: 10 (r + 1) + 2 r + 2, then averaged.
    want = {"a": np.mean([r + 1.0 for r in range(WORLD)]),
            "c": np.mean([10.0 * (r + 1) + 2 * r + 2 for r in range(WORLD)])}
    for r in ranks:
        assert r["integrator"] == pytest.approx(want)


def test_ranks_import_neither_jax_nor_mivos_tpu(ranks):
    assert [r["foreign_modules"] for r in ranks] == [[]] * WORLD


def test_sync_batch_norm_weights_from_flax():
    """A flax SyncBatchNorm's params and batch_stats load into the port's
    module under torch's names (checkpoint/from_jax.py)."""
    from mivos_tpu_torch.checkpoint.from_jax import state_dict_from_flax
    from mivos_tpu_torch.models.layers import SyncBatchNorm

    rng = np.random.RandomState(2)
    c = 5
    variables = {"params": {"scale": rng.rand(c), "bias": rng.randn(c)},
                 "batch_stats": {"mean": rng.randn(c), "var": rng.rand(c) + 0.5}}
    bn = SyncBatchNorm(c)
    bn.load_state_dict(state_dict_from_flax(variables), strict=True)
    bn.eval()
    x = rng.randn(2, 3, 4, c).astype(np.float32)
    ref = JSyncBatchNorm(c).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    out = bn(torch.from_numpy(_nchw(x)))
    np.testing.assert_allclose(np.moveaxis(out.detach().numpy(), 1, -1),
                               np.asarray(ref), atol=1e-5)


def test_sharded_sampler_covers_the_epoch(ranks):
    shards = [r["sampler"] for r in ranks]
    assert len({len(s) for s in shards}) == 1
    whole = ShardedSampler(R.SAMPLER_N, seed=3)
    whole.set_epoch(1)
    order = list(whole)
    # Shard s takes every WORLD-th index from s of the padded order.
    padded = order + order[:(-R.SAMPLER_N) % WORLD]
    assert [padded[s::WORLD] for s in range(WORLD)] == shards
    assert sorted(set(sum(shards, []))) == list(range(R.SAMPLER_N))
