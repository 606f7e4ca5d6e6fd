"""STM-style propagation network, NCHW inside (counterpart of
mivos_tpu/models/propagation.py; reference model/propagation/prop_net.py).

The object axis K is a batch axis throughout. Public layouts follow the
JAX package: frames (H, W, 3), masks (K, H, W, 1), banks (K, M, C) with
the 1/16 feature map flattened in row-major (h, w) order (the fused
kernel's bin partitions are keyed on that index), readouts (K, N, 512).
Intermediate features (f16, f8, f4, k16, v16, the skip towers) are NCHW
tensors, and `get_attention` returns NCHW (K, 2, H, W) maps, which is
what `FusionNet` takes.

`dec_width` scales the decoder's internal channels (JAX `Decoder.chan`):
1.0 is the reference decoder, the published checkpoints'
architecture; 0.5 the JAX package's opt-in slim decoder for nets
trained from scratch. `read_memory` routes the read as the JAX
network does (mivos_tpu/models/propagation.py:243-270): with `bank_mesh`
set, the banks are grids of position shards and the read is the exact
sharded read; with `object_mesh` set, grids of object shards read on
their own devices; otherwise the single-device read. `segment_logits`
is that read and `decode`; an object-sharded session reads with
gather=False and decodes each shard on its own device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mivos_tpu_torch.models.layers import (KeyValue, ResBlock, UpsampleBlock,
                                           conv3x3)
from mivos_tpu_torch.models import memorize_graph
from mivos_tpu_torch.models.resnet import ResNet50
from mivos_tpu_torch.ops.memory_read import (full_softmax_affinity,
                                             memory_read as _memory_read)
from mivos_tpu_torch.ops.resize import area_downsample, bilinear_resize
from mivos_tpu_torch.parallel.sharded_memory import (object_sharded_memory_read,
                                                     sharded_memory_read)

KEY_DIM = 128
VAL_DIM = 512


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., C, H, W)."""
    return x.movedim(-1, -3)


def _flatten_hw(x: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, h*w, C), row-major (h, w) positions."""
    return x.flatten(2).transpose(1, 2).contiguous()


class Decoder(nn.Module):
    """Refinement decoder: 1/16 -> 1/4 with skip connections, then a
    fp32 4x bilinear upsample to full resolution (reference
    prop_net.py:14-31). `width` scales every internal channel count
    (the inputs stay the readout and query value, f8 and f4)."""

    def __init__(self, width: float = 1.0):
        super().__init__()
        c = lambda n: self.chan(n, width)  # noqa: E731
        self.compress = ResBlock(1024, c(512))
        self.up_16_8 = UpsampleBlock(512, c(512), c(256))
        self.up_8_4 = UpsampleBlock(256, c(256), c(256))
        self.pred = conv3x3(c(256), 1)

    @staticmethod
    def chan(n: int, width: float) -> int:
        """Width-scaled channel count (mivos_tpu/models/propagation.py:47),
        shared with the session's query-cache sizing."""
        return max(16, int(round(n * width)))

    def skips(self, f8: torch.Tensor, f4: torch.Tensor):
        """Object-independent skip towers, run once per frame (batched
        over frames in the query pre-encode); the K-batched decode then
        runs with preskip=True on these."""
        return self.up_16_8.skip(f8), self.up_8_4.skip(f4)

    def forward(self, f16: torch.Tensor, f8: torch.Tensor, f4: torch.Tensor,
                preskip: bool = False) -> torch.Tensor:
        x = self.compress(f16)
        x = self.up_16_8(f8, x, preskip=preskip)
        x = self.up_8_4(f4, x, preskip=preskip)
        x = self.pred(F.relu(x)).to(torch.float32)
        return bilinear_resize(x, (x.shape[-2] * 4, x.shape[-1] * 4))


def compute_others(masks: torch.Tensor) -> torch.Tensor:
    """Sum of every other object's mask (reference prop_net.py:150-157);
    all zeros for K == 1. Works on any layout with objects first."""
    return masks.sum(dim=0, keepdim=True) - masks


class PropagationNetwork(nn.Module):
    """Memory encoder, query encoder, key/value heads and decoder.

    top_k: memory-read top-k (None = full softmax). read_backend: see
    ops/memory_read.memory_read ('auto' = the CUDA kernel for CUDA
    tensors, its plain version on the CPU; 'exact' = the torch.topk
    oracle). read_refine: threshold-refine passes of the kernel
    (default 0, as in the JAX package). dtype: the compute dtype the
    session casts the conv weights to (the bank inherits it).
    dec_width: the decoder's channel multiplier (1.0 the reference).

    Read routing, set by InferenceCore from MemoryConfig like `km`:
    `bank_mesh` (a Mesh; banks arrive as grids with their position axis
    over `bank_axis`, and over `object_axis` too when `object_mesh` is
    the same mesh: the 2D layout) or `object_mesh` (grids with the
    object axis over `object_axis`).
    """

    def __init__(self, top_k: Optional[int] = 50, read_backend: str = "auto",
                 read_refine: int = 0, dtype: torch.dtype = torch.float32,
                 dec_width: float = 1.0):
        super().__init__()
        self.top_k = top_k
        self.km: Optional[float] = None   # the kernelized read's sigma; InferenceCore sets it
        self.read_backend = read_backend
        self.read_refine = read_refine
        self.dtype = dtype
        self.dec_width = dec_width
        self.bank_mesh = None
        self.bank_axis = "data"
        self.object_mesh = None
        self.object_axis = "object"
        self.mask_rgb_encoder = ResNet50(in_chans=5, conv_bias=True)
        self.rgb_encoder = ResNet50(in_chans=3, conv_bias=False,
                                    layer1_name="res2")
        self.kv_m_f16 = KeyValue(1024, KEY_DIM, VAL_DIM)
        self.kv_q_f16 = KeyValue(1024, KEY_DIM, VAL_DIM)
        self.decoder = Decoder(dec_width)

    def memorize(self, frame: torch.Tensor, masks: torch.Tensor,
                 others: Optional[torch.Tensor] = None):
        """frame (H, W, 3), masks (K, H, W, 1) soft per-object masks ->
        keys (K, N, 128) and values (K, N, 512), N = H/16 * W/16.
        others: (K, H, W, 1), each object's sum of the frame's other
        masks, when `masks` holds only some of its objects (an object
        shard); by default computed from `masks`.

        On the card, outside autograd and dispatch modes, the call
        replays one CUDA graph per input signature
        (`models/memorize_graph.py`): the same kernels without their
        launches from Python."""
        if memorize_graph.eligible(frame):
            out = memorize_graph.run(self, frame, masks, others)
            if out is not None:
                return out
        return self._memorize_eager(frame, masks, others)

    def _memorize_eager(self, frame: torch.Tensor, masks: torch.Tensor,
                        others: Optional[torch.Tensor] = None):
        k = masks.shape[0]
        frames = _nchw(frame)[None].expand(k, -1, -1, -1)
        m = _nchw(masks).to(frames.dtype)
        others = compute_others(m) if others is None else _nchw(others).to(frames.dtype)
        x = torch.cat([frames, m, others], dim=1)
        f16 = self.mask_rgb_encoder(x)[0]
        k16, v16 = self.kv_m_f16(f16)
        return _flatten_hw(k16), _flatten_hw(v16)

    def get_query_values(self, frame: torch.Tensor):
        """frame (H, W, 3) -> batch-1 NCHW (f16, f8, f4, k16, v16)."""
        f16, f8, f4 = self.rgb_encoder(_nchw(frame)[None])
        k16, v16 = self.kv_q_f16(f16)
        return f16, f8, f4, k16, v16

    def get_query_values_batched(self, frames: torch.Tensor):
        """frames (B, H, W, 3) -> NCHW (skip8, skip4, k16, v16) for B
        frames at once: the decoder's skip towers are precomputed here
        (object-independent), so the per-frame decode runs with
        preskip=True."""
        f16, f8, f4 = self.rgb_encoder(_nchw(frames))
        k16, v16 = self.kv_q_f16(f16)
        skip8, skip4 = self.decoder.skips(f8, f4)
        return skip8, skip4, k16, v16

    def read_memory(self, mem_k, mem_v, valid, k16: torch.Tensor,
                    gather: bool = True):
        """The memory read of `segment_logits`, routed as the JAX network
        routes it (mivos_tpu/models/propagation.py:243-270): with
        `bank_mesh` the exact sharded read (2D when `object_mesh` is set
        too), else with `object_mesh` the object-sharded read, else the
        single-device read. Returns the (K, N, CV) fp32 readout on k16's
        device; gather=False: a list of the object shards' readouts,
        each on its shard's device (one entry unless object-sharded)."""
        h16, w16 = k16.shape[-2:]
        qk = k16[0].flatten(1).t()  # (h16*w16, 128), row-major positions
        if self.bank_mesh is not None:
            if self.km is not None:
                raise ValueError("km is unsupported with a sharded bank")
            top_k = self.top_k
            if top_k is None:   # a full softmax: every row of the bank
                top_k = sum(x.shape[1] for x in mem_k.reshape(-1))
            object_axis = None if self.object_mesh is None else self.object_axis
            return sharded_memory_read(
                self.bank_mesh, mem_k, mem_v, qk, top_k=top_k, valid=valid,
                axis=self.bank_axis, object_axis=object_axis, gather=gather)
        elif self.object_mesh is not None:
            return object_sharded_memory_read(
                self.object_mesh, mem_k, mem_v, qk, top_k=self.top_k,
                valid=valid, axis=self.object_axis, km=self.km,
                query_hw=(h16, w16), backend=self.read_backend,
                n_refine=self.read_refine, gather=gather)
        out = _memory_read(mem_k, mem_v, qk, top_k=self.top_k, valid=valid,
                           km=self.km, query_hw=(h16, w16),
                           backend=self.read_backend, n_refine=self.read_refine)
        return out if gather else [out]

    def decode(self, readout: torch.Tensor, f8, f4, v16,
               preskip: bool = False) -> torch.Tensor:
        """(K, N, CV) readout + the query's value and skips -> (K, H, W, 1)
        fp32 logits (reference prop_net.py:176-181)."""
        k = readout.shape[0]
        h16, w16 = v16.shape[-2:]
        readout = readout.transpose(1, 2).reshape(k, VAL_DIM, h16, w16)
        qv = v16.to(torch.float32).expand(k, -1, -1, -1)
        logits = self.decoder(torch.cat([readout, qv], dim=1), f8, f4,
                              preskip=preskip)
        return logits.movedim(1, -1)

    def segment_logits(self, mem_k, mem_v, valid, f16, f8, f4, k16, v16,
                       preskip: bool = False) -> torch.Tensor:
        """Memory read + decode before the sigmoid (reference
        prop_net.py:164-181). mem_k/mem_v: (K, M, C) bank, or grids of
        shards (see the class docstring); valid: optional (M,) bool.
        k16/v16/f8/f4: batch-1 NCHW query tensors (with preskip=True
        f8/f4 are the precomputed skip towers). Returns (K, H, W, 1)
        fp32 logits on the query's device. f16 is unused (the query key
        and value carry the 1/16 features), kept for the JAX signature."""
        del f16
        return self.decode(self.read_memory(mem_k, mem_v, valid, k16),
                           f8, f4, v16, preskip=preskip)

    def segment_with_query(self, mem_k, mem_v, valid, f16, f8, f4, k16, v16,
                           preskip: bool = False) -> torch.Tensor:
        """(K, H, W, 1) per-object sigmoid probabilities."""
        return torch.sigmoid(self.segment_logits(
            mem_k, mem_v, valid, f16, f8, f4, k16, v16, preskip=preskip))

    def get_attention(self, mk16: torch.Tensor, pos_mask: torch.Tensor,
                      neg_mask: torch.Tensor, qk16: torch.Tensor) -> torch.Tensor:
        """Difference-aware attention read (reference prop_net.py:183-200).
        mk16: (K, N, 128) keys of the interacted frame; pos/neg_mask:
        (K, H, W, 1) mask-change maps; qk16: (1, 128, h16, w16) query key.
        Returns NCHW (K, 2, H, W) upsampled [pos, neg] attention maps."""
        k, h, w = pos_mask.shape[:3]
        h16, w16 = h // 16, w // 16
        aff = full_softmax_affinity(mk16, qk16[0].flatten(1).t())  # (K, M, N)
        pos = area_downsample(_nchw(pos_mask), 16).reshape(k, 1, h16 * w16)
        neg = area_downsample(_nchw(neg_mask), 16).reshape(k, 1, h16 * w16)
        attn = torch.cat([torch.matmul(pos.to(torch.float32), aff),
                          torch.matmul(neg.to(torch.float32), aff)], dim=1)
        return bilinear_resize(attn.reshape(k, 2, h16, w16), (h, w))
