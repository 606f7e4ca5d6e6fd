#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mivos_tpu_torch) on one NVIDIA GPU.

Usage, from the repository root on a machine with an H100 and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. card    require CUDA; print `nvidia-smi` name and power limit;
             build the CUDA kernels from csrc/ and print the build time.
  2. gate    kernel_check.encoder_banks of a random-init fp32 encoder
             over 26 of synthetic_video's 480p frames (M = 21060 and
             42120, last 800 slots invalid), K = 3, fp32 and bf16:
             kernel_check.gate_session_shapes (the kernels against their
             plain PyTorch version, mean error <= 1e-4 of the readout
             scale, and against the exact torch.topk read, mean < 1e-3,
             max < 0.3 of the readout scale, n_refine 0 and 1; each
             kernel alone against its plain phase) and
             kernel_check.phase_timing: CUDA event timings of each kernel
             wrapper (kernel and merge; on fp32 banks on the read's bf16
             planes), its plain phase and its bound at M = 1620, 11340 and
             21060 (the smallest, middle and largest bank of a bench
             round), one line for bf16 banks and one for fp32 banks (with
             the whole read against the plain and exact reads at M =
             21060, two refine calls that must give equal bits, and each
             split-M kernel's number of M ranges); on fp32 banks also the
             planes of keys and values, made once a read. Bound
             (kernel_check.bound_ms): the tensor-core FLOPs at the bf16
             peak or the bytes at the memory rate, whichever is larger
             (the affinity as the JAX kernel's bf16 passes, two for bf16
             keys and three for fp32 keys, w.V as one bf16 pass on bf16
             banks and as three, fp32-accurate, on fp32 banks).
  3. check   a small fp32 session through the kernels against the same
             session through the exact read.
  4. session the bench protocol through InferenceCore.interact: 60
             frames 480x854, K=3, top_k=50, mem_freq=5, bf16 convs and
             bank; one warm and 3 measured rounds (frames/s); then a
             second interaction on frame 59 (fusion pass) and one round
             with read_refine=1, all with cuDNN autotune on. Then the
             same protocol with fp32 convs and bank: one warm and one
             measured round (frames/s), and one with read_refine=1. The
             launch counters, zeroed just before each of the two paths'
             measured rounds, must equal the reads times each kernel's
             launches per read (memory_read.launches_per_read). The slim
             decoder's A/B is slim_decoder_bench, in the measure phase.
  4b. long_video  long_video_bench.run_limit, its first LONG_ROUNDS
             rounds: 960 uint8 frames 480x854, K = 2, bf16, mem_freq=1,
             bank_cap_frames=512, the interaction on frame 0; the
             query cache off by its byte cap; the forward pass's commits
             thinned to every 2nd frame, the bank within the cap; labels
             (960, 480, 854) <= K; launch counters, zeroed before round
             1, equal to its reads times the launches per read; seconds
             per round, frames/s, peak GiB, committed slots and M. Then
             the gate of phase 2 at the M of its largest read (K = 2,
             N = 1620, no invalid slots, laid out as the bank's live
             prefix, fp32 and bf16) on a random-init fp32 encoder's
             banks over ceil(M / 1620) synthetic frames made on the card
             (synthetic_frames_dev), the references one object at a time
             (a dense fp32 affinity of one object is 5 GB there), and
             each kernel's CUDA-event ms at that M beside its bound.
  5. s2m     S2MController.interact at 480x854, bf16, hard aggregate:
             CUDA-event latency for K = 1, 2, 3, cuDNN autotune off
             with deterministic plans (as in the davis phase) and
             autotune on; output finite, in
             [0, 1], hard aggregate sums to 1; bf16-vs-fp32 hard-label
             agreement where fp32 decides, reported only.
  6. davis   run_local_interactive (the --local_robot loop) on two
             synthetic 50-frame 480x854 sequences, K = 2 and 3, 8
             rounds, bf16, top_k=50, mem_freq=5, cuDNN autotune off,
             deterministic plans (the same reads in every process):
             InferenceCore.interact exactly on the processor's 3rd, 6th
             and 8th interactions, update_mask_only otherwise;
             invariants after each call; launch counters, zeroed just
             before, equal to the reads of those rounds; J&F in [0, 1].
             Prints per-round times and the (random-init) summary. Then
             the gate of phase 2 again, fp32 and bf16, at every
             (K, N, M) those reads had, on banks laid out as the bank's
             live prefix; then a small fp32 lockstep: the same robot
             scribbles through an `auto` and an `exact` processor.
  7. fbrs    the f-BRS click path: random-init FBRSDeepLabModel
             ("resnet50", ch=128, the reference GUI's resnet50_dh128),
             fp32, through FBRSController (f-BRS-B, ZoomIn 480, L-BFGS
             maxiter 20) on a synthetic 480x854 frame: 5 clicks of the
             simulated user (NoC clicker) with cuDNN autotune off, a
             first use (new cuDNN shapes) and a repeat drive;
             per click host wall ms, head-input recompute, crop, L-BFGS
             iterations, evaluations and host flag reads, peak memory;
             every map finite, in [0, 1], 480x854; one undo (restores
             the previous map exactly) and one finish_object; no memory
             read kernel launched. Then card against CPU at 240x320,
             ZoomIn 240, 2 clicks: first click max |dp| <= 1e-3, then
             the same clicks and mask (p > 0.49) IoU >= 0.99. Then where
             a click's time goes: GFLOP from shapes, CUDA-event ms of the
             head input and of one L-BFGS evaluation, profiler traces.
  8. fbrs_modes  the rest of the f-BRS click path at 480x854, fp32,
             deterministic cuDNN plans (the chaotic input-space modes
             then choose the same clicks in every drive): the fbrs
             phase's model under f-BRS-A, f-BRS-C, RGB-BRS and
             DistMap-BRS (get_predictor, ZoomIn 480, expansion 1.4,
             L-BFGS maxiter 20), each a first-use and a repeat 5-click
             drive of the NoC user with per-click ms, iterations and
             evaluations, every map finite in [0, 1], every click after
             the first optimizing, the same clicks in both drives; the
             oracle (set_oracle_gt on the synthetic ground truth, f-BRS-B,
             3 clicks): its objective at the returned x no higher than at
             the x it started from; TiledPredictor, 4 crops of 320x480 and
             their flips in one batch of 8; a random-init
             HRNet-W32-OCR128 with non-trivial frozen-BN statistics
             (fbrs_hrnet_net): head input ms at the frame and peak
             memory, NoBRS, f-BRS-B (insertion A) and f-BRS-C (C) drives.
             No memory-read kernel launches in the phase. Then each new
             mode and HRNet's B and C card against CPU at 240x320, ZoomIn
             240, 2 clicks: the first map within 1e-3, the same clicks,
             mask IoU >= 0.99.
  9. serve   the HTTP session server, cuDNN autotune off with
             deterministic plans (as davis): SessionManager over the
             full-width bf16 nets on this card (max_sessions 2),
             warm(60, 480, 854, 3, 2 rounds), make_server on a free
             port. Session A (60 frames 480x854, K = 3, uint8 upload):
             interact on frame 0 while a second client polls /progress
             every 10 ms (a poll must see a partial round; time to the
             first non-empty poll), then on frame 59 (fusion); /masks
             equals the last answer. Session B, then two clients at once
             (A's frame 30, B's frame 0). Launch counters, zeroed before
             session A, equal the served reads times the launches per
             read. Every answer equals the same interactions through a
             direct InferenceCore on the manager's prepared nets;
             /metrics counts the rounds; DELETE both; the drain returns
             drained and empties the manager. Prints warm s, create ms,
             interact ms per round, first chunk ms, p50/p95 and the peak
             memory with two live sessions.
 10. gui     GuiSession with the full-width bf16 nets, a bf16 S2M and the
             fbrs phase's f-BRS model (fp32), on 60 uint8 frames 480x854,
             K = 2, deterministic plans: frame 0 scribbles for both
             objects (S2M), two free strokes and an undo, propagation
             (total 59, 59 steps); frame 40 a positive and a negative
             click on object 1, an undo (restores the first click's
             labels), a click on object 2, the fusion pass; frame 20 a
             200x150 local-control box with a free stroke, propagation.
             Launch counters against the reads; compose_frame in three
             modes; save_masks reads back equal; the masks the session
             handed the processor, replayed through a direct core, give
             equal labels. Prints S2M and click ms and each
             propagation's seconds.
 11. fusion_gen  python -m mivos_tpu_torch.generate_fusion's main() in
             process on a DAVIS-layout tree of three 20-frame 480x854
             JPEG videos with palette PNG annotations, K = 2, 3 and 0
             (no usable object), --separation 10, bf16, the random-init
             full-width PropagationNetwork saved as a reference-named
             .pth, deterministic cuDNN plans: every video directory, no
             staging left, the K = 0 video's directory empty, the PNG
             count (reference frames x usable objects x frames); one
             reference frame equal to a direct FusionGenerator run to
             within one uint8 level; launch counters, zeroed just
             before, equal to its reads times the launches per read; a
             re-run with --skip_done launches nothing; then the gate at
             every (K, N, M) the run read with, fp32 and bf16, as after
             the davis phase. Prints seconds and propagated frames/s per
             video.
 12. train   FusionDataset over phase 11's output, Loader (batch 12,
             8 workers, pinned memory) and FusionTrainer on the card:
             fp32, 384x384 crops, the reader's weights from phase 11's
             .pth (attention_read_state_dict), FusionNet random-init;
             1 warm and 20 measured steps (iterations 20, an lr drop at
             10, cuDNN autotune on): finite losses, the lr dropping at
             step 10; steps/s and samples/s over the measured window's
             wall time (loader waits and steps), median step ms, device
             ms (CUDA events) and loader wait, peak memory. Then, with
             deterministic plans, one step at batch 2 on the card and on the CPU from
             the same weights and batch (losses within 1e-4 relative,
             weights within 1e-6), and a checkpoint round trip (save,
             restore into a fresh trainer, one step on both: equal
             weights); the step alone (no loader worker running) and
             under the profiler; the loader alone, batches/s over 12
             batches past the 16 its workers queue at the start (the
             train CLI runs in the measure phase's synthetic_lifecycle).
             Phase 11 also splits its time into propagation
             and PNG writes.
 13. pretrain  synthetic pretraining (train/pretrain.py) with TF32 off:
             (1) a PropPretrainer on the card and one on the CPU from the
             same random-init weights, 48x48, 3 steps of chain_mix
             (1, 2), deterministic plans: losses within 1e-4 relative,
             every trained tensor within 3 * lr; (2) `python -m
             mivos_tpu_torch.pretrain_synthetic` in process at full width
             (the JAX recipe's first stages, cut): prop 300 steps at 192x192,
             lr 2e-4, chain 1, seeds from 1000, then chain-3 steps at
             256x448, lr 1e-4, for CHAIN3_BOX_S seconds (saved and logged
             through the CLI's writer); s2m 150 steps and fbrs 200 at
             batch 4, both at 192x192; batches built by 4 worker
             processes; per stage the median step, wait and CUDA-event
             device ms, peak GiB, one profiled prop step at each shape,
             and the mean loss and IoU
             of its first and last 25 steps: every loss finite, the last
             25 below the first 25 (chain 3: reported); the .pth files
             load strictly; (3) one interaction on frame 0 of a held-out
             20-frame 480x854 K = 2 synthetic video through InferenceCore,
             bf16, on the kernels (launch counters, zeroed just before,
             equal to its reads), with the pretrained and with a
             random-init propagation net: mean IoU against the ground
             truth and the share of object probabilities within 0.07 of
             0.5, reported, and the same at 192x192, the first stage's
             size; (4) the gate of phase 2 on banks of the
             pretrained fp32 encoder, built as the JAX gate builds them
             (kernel_check.encoder_banks); (5) `python -m
             mivos_tpu_torch.train_fusion_synthetic` in process from the
             pretrained prop weights: 24 videos of 12 frames at 384x384,
             separation 4, generate_fusion in fp32 (launch counters,
             zeroed just before, equal to its reads times the fp32 launches
             per read), 20 iterations at batch 12 with the loss
             descending; its seconds, PNG share and losses. Before the
             chain-3 steps the chain-1 prop weights are copied to
             prop_synthetic_s1.pth (curriculum_ab's single-step file).
 13b. accuracy  on the pretrain phase's weights, deterministic cuDNN
             plans: python -m mivos_tpu_torch.accuracy_envelope in
             process (prop and fusion .pth; fast: bf16 and the kernels,
             exact: fp32, TF32 off, the exact read; 30 frames 480x854,
             K = 3, 2 rounds) with its JAX gates (margin-conditioned
             agreement > 0.995, max probability error < 0.05), launch
             counters equal to the fast session's reads, then
             envelope_diagnose on its dump; python -m
             mivos_tpu_torch.full_protocol in process (prop and S2M
             .pth, fusion off, 2 sequences of 40 frames 480x854, K = 2,
             8 rounds): the bf16 fast path against the exact path,
             rounds inside 240 s, J&F in [0, 1], launch counters,
             zeroed just before, equal to the fast path's reads
             (counted at each interact) times the launches per read;
             max per-round |dJ&F| reported against the JAX bound 0.01,
             not held: on these weights JAX's own fast path crosses it
             too (scripts/torch_protocol_witness.sh, PERF.md).
 13c. measure  each measuring entry point's main in process at full
             width, on the pretrain phase's weights where it takes
             weights: bench (its in-process kernel gate, then 1 warm and 7
             measured bench-protocol sessions, cuDNN autotune on),
             slim_decoder_bench (width 1.0 then 0.5, 1 warm and 3 sessions
             each, autotune on), kernel_check (full mode on the chain-3
             prop weights: the encoder regime at M = 21060 gated, the iid
             regime at M = 20480 and 40960 reported, the cuda, exact and
             plain reads timed), refine_sweep (n_refine 0-3, the refine
             kernel and its merge launched n_refine times a read),
             mfu_report (--measure 8 --fps at bench's median),
             interactive_latency_bench, serve_streaming_bench (300 frames:
             the query cache must be off), train_step_bench, noc_synthetic
             (evaluate on the 200-step fbrs weights, its first NOC_SCENES
             scenes: NoC@80/85/90 and
             each scene's first IoU and clicks reported; the module's
             asserts not held, see phase_measure),
             curriculum_ab (the chain-3 prop weights against their chain-1
             snapshot) and synthetic_lifecycle at LIFE_ITERS iterations
             (its kill and resume, the loss descending). Each module holds
             its kernel launches to its reads; their counts join the
             kernels line.
 14. multichip  the multi-device paths, on distinct cards where the host
             has as many as a mesh has positions, else on meshes that
             repeat cuda:0 (printed): (1) the bank-sharded exact read on
             the gate's banks (K = 3, N = 1620, M = 21060 and 42120, the
             last TAIL slots invalid, fp32 and bf16) over 2 and 4
             position shards and 3 object x 2 position shards, and the
             object-sharded read over 3 object shards (the read kernels
             on each), the object-sharded and 2D reads as the sessions
             run them (each object shard's readout left on its device),
             against the unsharded exact read (the gate's bounds: mean
             < 1e-3, max < 0.3 of the readout scale), CUDA-event ms
             beside the exact and the kernel read; (2) bank-sharded (4 positions),
             object-sharded (3 objects) and 2D (3 x 2) sessions, the
             bench protocol's 60 frames 480x854, K = 3, a first round and
             a fusion round on frame 59, fp32 nets with TF32 off, held
             to the unsharded session on the same read backend (mc_sessions);
             the same modes in bf16, frames/s after a warm session, the
             read kernels' launches (zeroed just before each mode: the
             object-sharded reads launch each kernel once a read on
             every object shard, bank and 2D reads none) and, profiled,
             the CUDA kernels a frame; (3) DDP: 2 FusionTrainer steps at
             batch 12, 384x384, fp32, over min(4, cards) NCCL ranks, or
             2 gloo ranks on cuda:0 on one card, against one process on
             the whole batch, and SyncBatchNorm over the ranks against
             one process (mc_ddp); step ms of each; (4) the dry run
             (parallel/dryrun.py) on 4 positions.
The line before the last is {"kernels": [...]}, one entry per kernel
family of a bank dtype (KERNELS): "launches" sums its CUDA launches
(kernel and merge) over its paths (bf16: the session's bf16 rounds, the
davis run, serve, gui, fusion_gen, the pretrain phase's held-out
session, the multichip phase's bf16 object-sharded and 2D rounds, the
long video, the envelope's fast session, the full protocol's fast path,
and the measure phase's bench sessions, kernel_check, refine_sweep,
slim A/B, streaming rounds and curriculum passes; fp32: the session's
fp32 rounds, the pretrain phase's generate_fusion, the multichip phase's
fp32 object-sharded rounds, kernel_check and the lifecycle's
generate_fusion), "max_abs_err" is the worst of the gates of its bank
dtype (random-init, pretrained and long-video banks), "ms",
"plain_ms" and "bound_ms" are at M = 21060, and "long_M" holds the
kernel's ms and bound at the long video's M. The last line is
{"ok": true, "device": {...}}.
"""
import contextlib
import copy
import io
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from mivos_tpu_torch import (accuracy_envelope, bench, curriculum_ab, envelope_diagnose,
                             full_protocol, generate_fusion, interactive_latency_bench,
                             long_video_bench, mfu_report, noc_synthetic, pretrain_synthetic,
                             refine_sweep, serve_streaming_bench, slim_decoder_bench,
                             synthetic_lifecycle, train_fusion_synthetic, train_step_bench)
from mivos_tpu_torch import kernel_check as kc
from mivos_tpu_torch.checkpoint.manager import CheckpointManager, save_params
from mivos_tpu_torch.checkpoint.pth import (attention_read_state_dict,
                                            load_reference_pth, read_state_dict)
from mivos_tpu_torch.config import MemoryConfig, TrainConfig
from mivos_tpu_torch.core.davis_processor import DAVISProcessor
from mivos_tpu_torch.core.fusion_generator import FusionGenerator
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.data.fusion_dataset import FusionDataset
from mivos_tpu_torch.data.loader import Loader, ShardedSampler
from mivos_tpu_torch.data.transforms import im_normalize
from mivos_tpu_torch.data.video_datasets import DAVISTestDataset
from mivos_tpu_torch.eval.davis_interactive import run_local_interactive
from mivos_tpu_torch.eval.davis_metrics import SequenceJF
from mivos_tpu_torch.eval.robot import InteractiveScribblesRobot
from mivos_tpu_torch.generation.synthetic import labels_to_onehot, synthetic_sequence
from mivos_tpu_torch.interactive.clicker import Clicker
from mivos_tpu_torch.interactive.crops import TiledPredictor
from mivos_tpu_torch.interactive.fbrs_controller import (FBRSController,
                                                         InteractiveController)
from mivos_tpu_torch.interactive.fbrs_predictor import (_scale_bias_reg, _scaled_predict,
                                                        fbrs_objective, get_predictor)
from mivos_tpu_torch.interactive.gui_session import GuiSession
from mivos_tpu_torch.interactive.s2m_controller import S2MController
from mivos_tpu_torch.interactive.scribbles import is_empty, scribbles2mask
from mivos_tpu_torch.models import build_fbrs_from_state_dict
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from mivos_tpu_torch.models.fusion import AttentionReadNetwork, FusionNet
from mivos_tpu_torch.models.hrnet import FBRSHRNetModel
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.layers import FrozenBatchNorm, SyncBatchNorm
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.models.s2m import S2MNetwork
from mivos_tpu_torch.ops.cuda import memory_read as cmr
from mivos_tpu_torch.ops.cuda.build import load_library
from mivos_tpu_torch.ops.memory_read import memory_read
from mivos_tpu_torch.parallel.dryrun import dryrun_multichip, fusion_batch, train_rank
from mivos_tpu_torch.parallel.mesh import make_mesh, make_mesh_nd
from mivos_tpu_torch.parallel.ranks import run_ranks
from mivos_tpu_torch.parallel.sharded_memory import (object_sharded_memory_read, shard_bank,
                                                     sharded_memory_read)
from mivos_tpu_torch.serve import SessionManager, make_server, shutdown_gracefully
from mivos_tpu_torch.train.fbrs_losses import sigmoid_bce_from_probs
from mivos_tpu_torch.train.pretrain import PropPretrainer, batches
from mivos_tpu_torch.train.trainer import FusionTrainer
from mivos_tpu_torch.kernel_check import (TIMING_M, bound_ms, gate_read, gate_session_shapes,
                                           phase_timing, worst_errs)
from mivos_tpu_torch.utils.measure import cuda_ms, interaction_mask, reads_of
from mivos_tpu_torch.utils.tensor import (compute_pad, labels_to_probs,
                                          one_hot_mask, pad_divide_by, unpad)

T, RH, RW, K = 60, 480, 854, 3
TOP_K, MEM_FREQ = 50, 5
GATE_FRAMES, TAIL = 26, 800
MEASURED = 3
DAVIS_T, DAVIS_ROUNDS, DAVIS_SEQS = 50, 8, ((101, 2), (102, 3))  # (seed, K)
PROPAGATE_ON = (2, 5, 7)     # reference davis_processor.py:34
FBRS_CLICKS, FBRS_CHECK = 5, (240, 320, 2)   # check: h, w, clicks
FBRS_LOGIT_GAIN = 10.0       # as tests/test_torch_fbrs.py
FBRS_NEW_MODES = ("f-BRS-A", "f-BRS-C", "RGB-BRS", "DistMap-BRS")
HRNET_MODES = ("NoBRS", "f-BRS-B", "f-BRS-C")
TILE_CROP = (320, 480)
GEN_T, GEN_SEPARATION = 20, 10
FG_VIDEOS = ((61, 2), (62, 3), (63, 0))   # (seed, K); K = 0: no usable object
TRAIN_BATCH, TRAIN_STEPS = 12, 20
LOADER_BATCHES = 12   # the loader alone, past its initial queue
# Pretraining: the JAX recipe's first stages (scripts/r5_train_pipeline.sh:23,32,36).
PRE_LR, PRE_SEED, PRE_HW, PRE_WINDOW = 2e-4, 1000, 192, 25
PRE_STEPS = {"prop": 300, "s2m": 150, "fbrs": 200}
CHAIN3_HW, CHAIN3_LR, CHAIN3_SEED, CHAIN3_BOX_S = (256, 448), 1e-4, 2000, 10.0
HELD_OUT_SEED, HELD_T, HELD_K = 777, 20, 2   # outside every training seed
# Fusion on synthetic data: 24 videos (the JAX script's default) of 12
# frames at 384x384, two batches an epoch (one sample per video an
# epoch; the loader starts its workers anew each epoch).
FS_VIDEOS, FS_FRAMES, FS_HW, FS_SEPARATION, FS_ITERS, FS_REPORT = 24, 12, 384, 4, 20, 10
# The long video (long_video_bench --limit): its first LONG_ROUNDS rounds
# of three (the first reaches the bank's largest M); K = 2, N = 1620, the
# gate at its largest read's M.
LONG_ROUNDS, LONG_K = 1, 2
# The measure phase: the pretrain phase's single-step prop snapshot, and
# synthetic_lifecycle at reduced depth (its default: 400 iterations at
# batch 8, a checkpoint every 100, a report every 25; at batch 4 an
# epoch of its 12 videos holds 3 batches).
S1_NAME = "prop_synthetic_s1.pth"
LIFE_ITERS, LIFE_BATCH, LIFE_SAVE, LIFE_REPORT = 16, 4, 4, 2
NOC_SCENES = 6   # of noc_synthetic's 20 held-out scenes
SRC = "mivos_tpu_torch/csrc/memory_read.cu"
# The Pallas code each phase's kernels replace: the three pallas_calls'
# kernels, and the split of fp32 key tiles in `_affinity` that the
# planes kernel takes out of phases A and B, once a read.
REPLACES = {"candidates": "mivos_tpu/ops/pallas/memory_read.py:116",
            "refine": "mivos_tpu/ops/pallas/memory_read.py:221",
            "readout": "mivos_tpu/ops/pallas/memory_read.py:284",
            "hilo_planes": "mivos_tpu/ops/pallas/memory_read.py:108"}
BF16, F32 = torch.bfloat16, torch.float32
# One entry of the kernels line per kernel family: (name, phase, bank
# dtype, the launch counters of its CUDA launches).
KERNELS = (("candidates_bf16", "candidates", BF16, ("candidates_bf16", "candidates_merge")),
           ("refine_bf16", "refine", BF16, ("refine_bf16", "refine_merge")),
           ("readout_bf16", "readout", BF16, ("readout_bf16", "readout_merge")),
           ("candidates_f32", "candidates", F32, ("candidates_f32", "candidates_merge")),
           ("refine_f32", "refine", F32, ("refine_f32", "refine_merge")),
           ("readout_f32", "readout", F32, ("readout_f32", "readout_merge")),
           ("hilo_planes", "hilo_planes", F32, ("hilo_planes",)))
MEAN, STD = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def synthetic_video(seed, t, h, w, k):
    """Normalized frames (t, h, w, 3) of k drifting coloured ellipses on
    a textured background, and their label maps (t, h, w)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    colours = rng.rand(k + 1, 3).astype(np.float32)
    centre = rng.rand(k, 2) * [h, w]
    vel = rng.randn(k, 2) * 4.0
    radii = rng.uniform(40, 140, (k, 2))
    bg = 0.2 * np.sin(yy[..., None] / rng.uniform(5, 30, 3)
                      + xx[..., None] / rng.uniform(5, 30, 3))
    frames = np.empty((t, h, w, 3), np.float32)
    labels = np.zeros((t, h, w), np.int64)
    for i in range(t):
        for o in range(k):
            cy, cx = centre[o] + vel[o] * i
            inside = (((yy - cy) / radii[o, 0]) ** 2
                      + ((xx - cx) / radii[o, 1]) ** 2) <= 1.0
            labels[i][inside] = o + 1
        img = colours[labels[i]] + bg + 0.05 * rng.randn(h, w, 3)
        frames[i] = ((img - MEAN) / STD).astype(np.float32)
    return frames, labels


def phase_card():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} capability "
        f"{torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    lib = load_library()
    log(f"kernels built+loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
    return card


def phase_gate(dev):
    """kernel_check's gate at the session's read shapes (K = 3, M = 21060
    and 42120, the last TAIL slots invalid), fp32 and bf16, on the banks
    a random-init encoder memorizes over synthetic_video's frames (seed
    7), and kernel_check.phase_timing. Returns each kernel's worst error,
    the timings and the gate banks, which the DAVIS, fusion_gen and
    multichip gates reuse."""
    mk_all, mv_all, q = kc.encoder_banks(kc.prop_net(None), GATE_FRAMES, dev,
                                         synthetic_video(7, GATE_FRAMES + 1, RH, RW, K))
    errs = gate_session_shapes(mk_all, mv_all, q, "random-init", log)
    timing = {dtype: phase_timing(mk_all, mv_all, q, dtype, log) for dtype in (BF16, F32)}
    return errs, timing, (mk_all, mv_all, q)


def bank_prefix(x, k, m, dtype):
    """x[:k, :m] in `dtype`, laid out as MemoryBank.live() hands it to the
    kernels: rows contiguous, the object axis striding over a buffer one
    slot longer."""
    n16 = (-(-RH // 16)) * (-(-RW // 16))
    buf = torch.empty((k, m + n16, x.shape[2]), dtype=dtype, device=x.device)
    buf[:, :m] = x[:k, :m]
    return buf[:, :m]


def phase_gate_davis(banks, shapes, path="davis"):
    """The gate again, fp32 and bf16, at every (K, N, M) a path (the
    DAVIS path, fusion_gen) read with, on gate banks laid out as the
    bank's live prefix (no invalid slots, as there). Returns each
    kernel's worst error."""
    mk_all, mv_all, q = banks
    kernel_reps, worst = [], {"vs_plain_mean": 0.0, "vs_exact_mean": 0.0,
                              "vs_exact_max": 0.0}
    for k, n, m in sorted(shapes):
        check(n == q.shape[0] and k <= mk_all.shape[0] and m <= mk_all.shape[1],
              f"{path} read shape {(k, n, m)} outside the gate banks "
              f"{tuple(mk_all.shape)}, N = {q.shape[0]}")
        for dtype in (F32, BF16):
            reps, kernel_rep = gate_read(bank_prefix(mk_all, k, m, dtype),
                                         bank_prefix(mv_all, k, m, dtype), q, None)
            kernel_reps.append(kernel_rep)
            for rep in reps:
                for key in worst:
                    worst[key] = max(worst[key], rep[key] / rep["readout_scale"])
    errs = worst_errs(kernel_reps)
    log(json.dumps({f"{path}_gate_shapes_KNM": sorted(shapes),
                    "dtypes": ["float32", "bfloat16"],
                    "worst_over_readout_scale": worst,
                    "per_kernel_max_abs_err": errs}))
    return errs


def synthetic_frames_dev(seed, t, h, w, k, dev):
    """synthetic_video's construction, made on the card one frame at a
    time (a long video's frames would take minutes in numpy), the
    ellipses wrapping round the frame edges so that they stay in view:
    yields each normalized (h, w, 3) frame and its (h, w) labels."""
    gen = torch.Generator(dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    yy, xx = torch.meshgrid(torch.arange(h, dtype=F32, device=dev),
                            torch.arange(w, dtype=F32, device=dev), indexing="ij")
    colours = rand(k + 1, 3)
    hw = torch.tensor([h, w], dtype=F32, device=dev)
    centre = rand(k, 2) * hw
    vel = torch.randn((k, 2), generator=gen, device=dev) * 4.0
    radii = 40.0 + 100.0 * rand(k, 2)
    bg = 0.2 * torch.sin(yy[..., None] / (5.0 + 25.0 * rand(3))
                         + xx[..., None] / (5.0 + 25.0 * rand(3)))
    mean = torch.tensor(MEAN, dtype=F32, device=dev)
    std = torch.tensor(STD, dtype=F32, device=dev)
    for i in range(t):
        labels = torch.zeros((h, w), dtype=torch.int64, device=dev)
        for o in range(k):
            cy, cx = torch.remainder(centre[o] + vel[o] * i, hw)
            inside = ((yy - cy) / radii[o, 0]) ** 2 + ((xx - cx) / radii[o, 1]) ** 2 <= 1.0
            labels[inside] = o + 1
        img = colours[labels] + bg + 0.05 * torch.randn((h, w, 3), generator=gen, device=dev)
        yield (img - mean) / std, labels


def long_gate_banks(dev, m):
    """gate_banks at a long video's M: the random-init fp32 encoder's
    banks over ceil(M / N) synthetic 480p frames (synthetic_frames_dev),
    K = LONG_K, and the query key of the next frame."""
    net = init_params(PropagationNetwork(top_k=TOP_K),
                      torch.Generator().manual_seed(0)).to(dev).eval()
    n16 = (-(-RH // 16)) * (-(-RW // 16))
    frames = -(-m // n16)
    mk = torch.empty((LONG_K, frames * n16, cmr.CK), dtype=F32, device=dev)
    mv = torch.empty((LONG_K, frames * n16, cmr.CV), dtype=F32, device=dev)
    with torch.no_grad():
        for t, (frame, labels) in enumerate(synthetic_frames_dev(7, frames + 1, RH, RW,
                                                                 LONG_K, dev)):
            frame = pad_divide_by(frame)[0]
            if t == frames:
                k16 = net.get_query_values(frame)[3]
                break
            masks = pad_divide_by(one_hot_mask(labels, LONG_K))[0]
            mk[:, t * n16:(t + 1) * n16], mv[:, t * n16:(t + 1) * n16] = net.memorize(frame, masks)
    return mk, mv, k16[0].flatten(1).t().contiguous()


def long_timing(mk, mv, q, dtype):
    """CUDA-event ms of each kernel wrapper (kernel and merge; on fp32
    banks on the read's planes, and the planes) and of the whole kernel
    read on one long bank (no invalid slots, as the session reads it),
    beside bound_ms."""
    m, k, n = mk.shape[1], mk.shape[0], q.shape[0]
    rq = cmr.read_query(q)
    planes = None if dtype == BF16 else cmr.bank_planes_cuda(mk, mv)
    st = cmr.candidates_cuda(rq, mk, None, TOP_K, planes)
    ms = {"candidates": cuda_ms(lambda: cmr.candidates_cuda(rq, mk, None, TOP_K, planes), 5, 1),
          "refine": cuda_ms(lambda: cmr.refine_cuda(rq, mk, None, st, TOP_K, planes), 5, 1),
          "readout": cuda_ms(lambda: cmr.readout_cuda(rq, mk, mv, None, st, planes), 5, 1)}
    if dtype == F32:
        ms["hilo_planes"] = cuda_ms(lambda: cmr.bank_planes_cuda(mk, mv), 5, 1)
    bounds = {name: bound_ms(name, k, n, m, dtype) for name in ms}
    rep = {"timing_long": str(dtype)[6:], "K": k, "N": n, "M": m, "kernel_ms": ms,
           "bound_ms": {name: b[0] for name, b in bounds.items()},
           "bound_by": {name: b[1] for name, b in bounds.items()},
           "share_of_bound": {name: bounds[name][0] / ms[name] for name in ms},
           "kernel_read_ms": cuda_ms(lambda: cmr.memory_read_threshold_cuda(
               mk, mv, q, TOP_K, None), 5, 1)}
    log(json.dumps(rep))
    return rep


def phase_long_video(dev):
    """The 960-frame session at the bank's frame cap
    (long_video_bench.run_limit, its first LONG_ROUNDS rounds; it zeroes
    the launch counters before round 1 and holds them to the reads), then
    the gate, per object, and the kernel times at the M of its largest
    read, fp32 and bf16 banks. Returns its launch counts, each kernel's
    worst gate error and the long-M timings."""
    t0 = time.perf_counter()
    prop = long_video_bench.make_net(dev, BF16)
    with cudnn_mode(benchmark=True):
        rep = long_video_bench.run_limit(prop, dev, rounds=LONG_ROUNDS, log=log)
    counts = cmr.launch_counts()
    for c in ("candidates_bf16", "readout_bf16"):
        check(counts[c] > 0, f"{c} never launched on the long video")
    rep["session_s"] = time.perf_counter() - t0
    log(json.dumps({"phase": "long_video", **rep}))
    del prop
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    m = rep["max_read_M"]
    mk_all, mv_all, q = long_gate_banks(dev, m)
    kernel_reps, timing = [], {}
    for dtype in (F32, BF16):
        mk, mv = bank_prefix(mk_all, LONG_K, m, dtype), bank_prefix(mv_all, LONG_K, m, dtype)
        reps, kernel_rep = gate_read(mk, mv, q, None, per_object=True)
        for r in reps + [kernel_rep]:
            log(json.dumps(dict(r, banks="random-init long video")))
        kernel_reps.append(kernel_rep)
        timing[dtype] = long_timing(mk, mv, q, dtype)
        del mk, mv
        torch.cuda.empty_cache()
    errs = worst_errs(kernel_reps)
    log(json.dumps({"long_gate_per_kernel_max_abs_err": errs, "M": m,
                    "gate_s": time.perf_counter() - t1}))
    return counts, errs, timing, m


def make_nets(dev, dtype, read_backend="auto", seed=0):

    gen = torch.Generator().manual_seed(seed)
    prop = init_params(PropagationNetwork(top_k=TOP_K, read_backend=read_backend,
                                          dtype=dtype), gen)
    fuse = init_params(FusionNet(dtype=dtype), gen)
    return prop.to(dev), fuse.to(dev)


def phase_check(dev):
    """Small fp32 session: the kernel path against the exact-read path."""
    t, h, w = 10, 240, 427
    frames, labels = synthetic_video(11, t, h, w, K)
    lab0 = labels[0]
    fg = (lab0[None] == np.arange(1, K + 1)[:, None, None]).astype(np.float32)
    mask = np.concatenate([1.0 - fg.sum(0, keepdims=True), fg])[..., None]
    mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ)
    probs = {}
    for backend in ("auto", "exact"):
        prop, fuse = make_nets(dev, torch.float32, backend, seed=3)
        core = InferenceCore(prop, fuse, frames, K, mem=mem, device=dev)
        core.interact(mask, 0)
        probs[backend] = torch.stack([core.get_prob(i) for i in range(t)])
    diff = (probs["auto"] - probs["exact"]).abs()
    top2 = probs["exact"][:, :, 0].topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > 0.05
    agree = (probs["auto"][:, :, 0].argmax(1) == probs["exact"][:, :, 0].argmax(1))
    rep = {"small_session": [t, h, w], "mean_abs_prob_diff": diff.mean().item(),
           "max_abs_prob_diff": diff.max().item(),
           "decided_frac": decided.float().mean().item(),
           "decided_agreement": (agree[decided].float().mean().item()
                                 if decided.any() else 1.0)}
    log(json.dumps(rep))
    check(rep["mean_abs_prob_diff"] < 1e-3, f"kernel vs exact session {rep}")
    check(rep["decided_agreement"] >= 0.999, f"kernel vs exact session {rep}")


def session_invariants(core, labels):
    """Labels (T, H, W) uint8 <= K; every frame that holds probabilities
    has finite ones that sum to 1 over the classes."""
    check(labels.shape == (core.t, core.h, core.w) and labels.dtype == np.uint8,
          f"labels {labels.shape} {labels.dtype}")
    check(int(labels.max()) <= core.k, "label out of range")
    lw, uw, lh, uh = core.pad
    worst = torch.zeros((), device=core.device)
    finite = torch.ones((), dtype=torch.bool, device=core.device)
    touched = [ti for ti in range(core.t) if core.prob[ti] is not None]
    check(len(touched) > 0, "no frame holds probabilities")
    for ti in touched:
        p = core.get_prob(ti)[:, 0, lh:core.nh - uh, lw:core.nw - uw]
        finite &= torch.isfinite(p).all()
        worst = torch.maximum(worst, (p.sum(0) - 1.0).abs().max())
    check(bool(finite), "non-finite probabilities")
    check(worst.item() < 1e-4, f"probabilities sum to 1 +- {worst.item()}")


def check_read_launches(counts_before, reads, read_refine, bank_dtype):
    """Every counter rose by `reads` times its launches per read; return
    the counts now."""
    got = cmr.launch_counts()
    for name, per_read in cmr.launches_per_read(bank_dtype, read_refine).items():
        check(got[name] - counts_before[name] == per_read * reads,
              f"{name}: {got[name] - counts_before[name]} launches for "
              f"{reads} reads")
    return got


def run_round(core, mask, idx, counts_before):

    reads = reads_of(core, idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = core.interact(mask, idx)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    session_invariants(core, labels)
    got = check_read_launches(counts_before, reads, core.prop_net.read_refine,
                              core.bank.dtype)
    return dt, reads, got


@contextlib.contextmanager
def cudnn_mode(benchmark, deterministic=False):
    """cuDNN autotune and deterministic flags for the block, restored
    after. Autotune picks algorithms by timing, so they (and their
    rounding) differ from process to process, and each new shape pays the
    search in its first call. PyTorch caches the plan per shape and flags
    and reuses an autotuned plan after autotune is switched off; plans
    chosen under deterministic=True are cached apart and never autotuned
    here, so a block under cudnn_mode(False, True) computes the same in
    every process, whatever ran before it."""
    cudnn = torch.backends.cudnn
    before = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = benchmark, deterministic
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = before


def phase_session(dev):
    prop, fuse = make_nets(dev, torch.bfloat16)
    rng = np.random.RandomState(0)
    # Frames and interaction masks reach the device before the timed
    # rounds, as in bench.py.
    images = torch.from_numpy(rng.rand(T, RH, RW, 3).astype(np.float32)).to(dev)
    masks = [interaction_mask(s, RH, RW, K, dev) for s in range(8)]
    mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ)

    warm = InferenceCore(prop, fuse, images, K, mem=mem, device=dev)
    dt, _, _ = run_round(warm, masks[7], 0, cmr.launch_counts())
    log(f"warm round: {dt:.3f} s")
    del warm

    cmr.reset_launch_counts()   # the main path's launches start here
    counts = cmr.launch_counts()
    fps, total_reads = [], 0
    for s in range(MEASURED):
        core = InferenceCore(prop, fuse, images, K, mem=mem, device=dev)
        dt, reads, counts = run_round(core, masks[s], 0, counts)
        total_reads += reads
        fps.append((T - 1) / dt)
        log(f"round {s}: {dt:.3f} s, {fps[-1]:.2f} frames/s, {reads} reads, "
            f"bank slots {core.bank.num_slots}, peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    dt, reads, counts = run_round(core, masks[3], T - 1, counts)
    total_reads += reads
    log(f"fusion round (interaction on frame {T - 1}): {dt:.3f} s, "
        f"{reads} reads")
    refine_net = copy.copy(prop)
    refine_net.read_refine = 1
    core = InferenceCore(refine_net, fuse, images, K, mem=mem, device=dev)
    dt, reads, counts = run_round(core, masks[4], 0, counts)
    total_reads += reads
    log(f"read_refine=1 round: {dt:.3f} s, {reads} reads")
    counts = cmr.launch_counts()
    med = sorted(fps)[len(fps) // 2]
    log(json.dumps({"metric": "propagation_fps_480p_3obj", "median": med,
                    "rounds": fps, "reads": total_reads,
                    "launches": counts}))
    f32_counts = session_f32(dev, images, masks, mem)
    return counts, f32_counts


def session_f32(dev, images, masks, mem):
    """The bench protocol on fp32 convs and an fp32 bank: one warm round,
    one measured (frames/s), one with read_refine=1. Returns the launch
    counts of the last two, zeroed just before them."""
    prop, fuse = make_nets(dev, F32)
    warm = InferenceCore(prop, fuse, images, K, mem=mem, device=dev)
    dt, _, _ = run_round(warm, masks[7], 0, cmr.launch_counts())
    log(f"fp32 warm round: {dt:.3f} s")
    del warm
    cmr.reset_launch_counts()   # the fp32 path's launches start here
    core = InferenceCore(prop, fuse, images, K, mem=mem, device=dev)
    dt, reads, counts = run_round(core, masks[5], 0, cmr.launch_counts())
    refine_net = copy.copy(prop)
    refine_net.read_refine = 1
    core = InferenceCore(refine_net, fuse, images, K, mem=mem, device=dev)
    dt_refine, reads_refine, counts = run_round(core, masks[6], 0, counts)
    check(reads_refine == T - 1, f"read_refine=1 round: {reads_refine} reads")
    log(json.dumps({"metric": "propagation_fps_480p_3obj_fp32", "frames_s": (T - 1) / dt,
                    "round_s": dt, "read_refine1_round_s": dt_refine,
                    "reads": reads + reads_refine, "bank_slots": core.bank.num_slots,
                    "launches": counts}))
    return counts


def phase_s2m(dev):
    """S2MController.interact at 480x854 for K = 1, 2, 3 (bf16, hard
    aggregate, the DAVIS controller settings): CUDA-event latency after
    warm-up, output gates, and bf16-vs-fp32 agreement (reported)."""
    net32 = init_params(S2MNetwork(), torch.Generator().manual_seed(5)).to(dev)
    net16 = copy.deepcopy(net32)
    net16.dtype = torch.bfloat16
    robot = InteractiveScribblesRobot()
    rep = {"phase": "s2m", "hw": [RH, RW], "dtype": "bfloat16", "ms": {},
           "ms_cudnn_benchmark": {}, "decided_frac": {},
           "bf16_fp32_agreement": {}}
    for k in (1, 2, 3):
        frames, gt = synthetic_video(20 + k, 1, RH, RW, k)
        scr = robot.interact(np.zeros_like(gt), gt, k)
        scr_mask = scribbles2mask(scr, (RH, RW))[0]
        image = pad_divide_by(torch.from_numpy(frames[0]).to(dev))[0]
        prev = pad_divide_by(torch.from_numpy(np.roll(gt[0], 40, axis=1)).to(dev),
                             16, hw_axes=(-2, -1))[0]
        c16 = S2MController(net16, k, ignore_class=-1, dilate_radius=1, device=dev)
        c32 = S2MController(net32, k, ignore_class=-1, dilate_radius=1, device=dev)
        def call():
            return c16.interact(image, prev, scr_mask, aggregate_hard=True)

        with cudnn_mode(benchmark=False, deterministic=True):  # as in davis
            rep["ms"][k] = cuda_ms(call, iters=10, warmup=3)
        with cudnn_mode(benchmark=True):   # the warm-up absorbs the search
            rep["ms_cudnn_benchmark"][k] = cuda_ms(call, iters=10, warmup=3)
        prob = c16.interact(image, prev, scr_mask)
        hard = c16.interact(image, prev, scr_mask, aggregate_hard=True)
        check(tuple(hard.shape) == (k + 1,) + tuple(image.shape[:2]) + (1,),
              f"hard aggregate shape {tuple(hard.shape)}")
        for name, x in (("prob", prob), ("hard", hard)):
            check(bool(torch.isfinite(x).all()), f"s2m {name} not finite")
            check(float(x.min()) >= 0.0 and float(x.max()) <= 1.0,
                  f"s2m {name} outside [0, 1]")
        check((hard.sum(0) - 1.0).abs().max().item() < 1e-4,
              "s2m hard aggregate does not sum to 1")
        hard32 = c32.interact(image, prev, scr_mask, aggregate_hard=True)
        raw16, raw32 = (unpad(x[..., 0], compute_pad(RH, RW), hw_axes=(-2, -1))
                        for x in (hard, hard32))
        decided = raw32.max(0).values > 0.99
        agree = raw16.argmax(0) == raw32.argmax(0)
        rep["decided_frac"][k] = decided.float().mean().item()
        rep["bf16_fp32_agreement"][k] = (agree[decided].float().mean().item()
                                         if decided.any() else 1.0)
    log(json.dumps(rep))
    del net16, net32


@contextlib.contextmanager
def recorded_read_shapes(read_shapes):
    """Add the (K, N, M) of every kernel read within the block to
    `read_shapes`."""
    orig_candidates = cmr.candidates_cuda

    def candidates_cuda(rq, mem_k, mask, top_k, planes=None):
        read_shapes.add((mem_k.shape[0], rq.rows, mem_k.shape[1]))
        return orig_candidates(rq, mem_k, mask, top_k, planes)

    cmr.candidates_cuda = candidates_cuda
    try:
        yield
    finally:
        cmr.candidates_cuda = orig_candidates


@contextlib.contextmanager
def watched_cores(calls, read_shapes):
    """Wrap InferenceCore.interact / update_mask_only for the duration:
    record each call per session, check the kernel launches it made
    against its memory reads, and check the session invariants. Record
    the (K, N, M) of every read in `read_shapes`."""
    orig_interact, orig_update = InferenceCore.interact, InferenceCore.update_mask_only

    def interact(self, mask, idx):
        reads, before = reads_of(self, idx), cmr.launch_counts()
        labels = orig_interact(self, mask, idx)
        check_read_launches(before, reads, self.prop_net.read_refine,
                            self.bank.dtype)
        session_invariants(self, labels)
        calls.setdefault(self, []).append(("interact", reads))
        return labels

    def update_mask_only(self, mask, idx):
        before = cmr.launch_counts()
        labels = orig_update(self, mask, idx)
        check_read_launches(before, 0, 0, self.bank.dtype)
        session_invariants(self, labels)
        calls.setdefault(self, []).append(("update", 0))
        return labels

    InferenceCore.interact, InferenceCore.update_mask_only = interact, update_mask_only
    try:
        with recorded_read_shapes(read_shapes):
            yield
    finally:
        InferenceCore.interact, InferenceCore.update_mask_only = orig_interact, orig_update


def phase_davis(dev):
    """The DAVIS interactive protocol through run_local_interactive, with
    cuDNN autotune off as the entry point runs it, and deterministic
    plans (see cudnn_mode): autotuned rounding differs between processes
    and flips near-tied random-init pixels, and the robot's scribbles and
    the reads would follow. Returns the launch counts and the (K, N, M)
    of every read."""
    prop, fuse = make_nets(dev, torch.bfloat16)
    s2m = init_params(S2MNetwork(dtype=torch.bfloat16),
                      torch.Generator().manual_seed(5))
    seqs = {}
    for seed, k in DAVIS_SEQS:
        frames, labels = synthetic_video(seed, DAVIS_T, RH, RW, k)
        seqs[f"synthetic{seed}_k{k}"] = (frames, labels, k)
    mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ)
    calls, read_shapes = {}, set()
    with (watched_cores(calls, read_shapes),
          cudnn_mode(benchmark=False, deterministic=True)):
        cmr.reset_launch_counts()   # the DAVIS path's launches start here
        t0 = time.perf_counter()
        summary = run_local_interactive(prop, fuse, s2m, seqs,
                                        max_nb_interactions=DAVIS_ROUNDS,
                                        mem=mem, device=dev)
        wall = time.perf_counter() - t0
        counts = cmr.launch_counts()
    rounds = summary["rounds"]
    for r in rounds:
        log(json.dumps({"davis_round": r}))
    check(len(calls) == len(seqs), f"{len(calls)} sessions for {len(seqs)} sequences")
    total_reads = 0
    for (name, (_f, _l, k)), seq_calls in zip(seqs.items(), calls.values()):
        done = [r for r in rounds if r["sequence"] == name]
        skipped = sum(r["skipped"] for r in done)
        check(len(done) == DAVIS_ROUNDS, f"{name}: {len(done)} rounds")
        kinds = [c for c, _ in seq_calls]
        want = ["interact" if i in PROPAGATE_ON else "update"
                for i in range(DAVIS_ROUNDS - skipped)]
        check(kinds == want, f"{name}: calls {kinds}, expected {want}")
        check([r["propagated"] for r in done if not r["skipped"]]
              == [c == "interact" for c in want], f"{name}: round records")
        total_reads += sum(n for _, n in seq_calls)
        log(f"{name}: K={k}, skipped rounds {skipped}, reads {sum(n for _, n in seq_calls)}")
    check(counts == {name: n * total_reads
                     for name, n in cmr.launches_per_read(BF16, 0).items()},
          f"launches {counts} for {total_reads} reads")
    check(total_reads > 0, "the DAVIS path made no memory read")
    jf = [v for traj in summary["records"].values() for _, v in traj]
    check(all(0.0 <= v <= 1.0 for v in jf), f"J&F outside [0, 1]: {jf}")
    timed = [r for r in rounds if not r["skipped"]]
    upd = [r["interact_s"] for r in timed if not r["propagated"]]
    prp = [r["interact_s"] for r in timed if r["propagated"]]
    log(json.dumps({
        "phase": "davis", "sequences": {n: [DAVIS_T, RH, RW, k] for n, (_f, _l, k) in seqs.items()},
        "wall_s": wall, "update_round_s": upd, "propagate_round_s": prp,
        "update_round_median_s": sorted(upd)[len(upd) // 2],
        "robot_s_mean": float(np.mean([r["robot_s"] for r in rounds])),
        "metrics_s_mean": float(np.mean([r["metrics_s"] for r in rounds])),
        "protocol_elapsed_s": {n: [t for t, _ in traj]
                               for n, traj in summary["records"].items()},
        "jf": {n: [v for _, v in traj] for n, traj in summary["records"].items()},
        "random_init_auc": summary["auc"],
        "random_init_jf_at_60s": summary["metric_at_60s"],
        "reads": total_reads, "launches": counts,
        "read_shapes": len(read_shapes)}))
    check(len(read_shapes) > 0, "no read shape recorded")
    return counts, read_shapes


def phase_davis_check(dev):
    """Small fp32 lockstep: the same robot scribbles through a processor
    reading with the kernels (`auto`) and one reading with torch.topk
    (`exact`); labels must agree where the exact one decides."""
    t, h, w, k = 10, 240, 427, 2
    frames, gt = synthetic_video(13, t, h, w, k)
    s2m = init_params(S2MNetwork(), torch.Generator().manual_seed(6))
    mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ)
    procs = {}
    for backend in ("auto", "exact"):
        prop, fuse = make_nets(dev, torch.float32, backend, seed=3)
        procs[backend] = DAVISProcessor(prop, fuse, s2m, frames, k, mem=mem,
                                        device=dev)
    metrics, robot = SequenceJF(gt, k, dev), InteractiveScribblesRobot()
    pred, cand = np.zeros_like(gt), None
    n_dec = n_agree = 0
    worst = 0.0
    for _ in range(DAVIS_ROUNDS):
        scr = robot.interact(pred, gt, k, candidates=cand,
                             region_j=metrics.region_j(pred))
        if is_empty(scr):
            continue
        outs = {b: p.interact(scr) for b, p in procs.items()}
        cores = {b: p.processor for b, p in procs.items()}
        for ti in range(cores["exact"].t):
            if cores["exact"].prob[ti] is None:
                continue
            pa, pe = cores["auto"].get_prob(ti)[:, 0], cores["exact"].get_prob(ti)[:, 0]
            top2 = pe.topk(2, dim=0).values
            decided = (top2[0] - top2[1]) > 0.05
            n_dec += int(decided.sum())
            n_agree += int((pa.argmax(0) == pe.argmax(0))[decided].sum())
            worst = max(worst, (pa - pe).abs().max().item())
        pred, cand = outs["exact"][0].copy(), outs["exact"][1]
    rep = {"davis_lockstep": [t, h, w, k], "decided_pixels": n_dec,
           "decided_agreement": n_agree / max(n_dec, 1),
           "max_abs_prob_diff": worst}
    log(json.dumps(rep))
    check(n_dec > 0 and rep["decided_agreement"] >= 0.999,
          f"auto vs exact DAVIS lockstep {rep}")


def fbrs_net():
    """Random-init FBRSDeepLabModel("resnet50", ch=128), on the host. The
    last conv is scaled by FBRS_LOGIT_GAIN, as the CPU tests do, so the
    random logits spread over O(1) around the mask threshold."""
    net = init_params(FBRSDeepLabModel("resnet50", ch=128, norm_radius=260.0),
                      torch.Generator().manual_seed(11))
    with torch.no_grad():
        net.head.layers[2].weight.mul_(FBRS_LOGIT_GAIN)
    return net


def fbrs_drive(ctl, image, gt, n, dev):
    """n clicks of the NoC user (Clicker over gt, the mask p > 0.49)
    through ctl, an FBRSController or InteractiveController on an
    anchored image. Returns the clicks, each click's record and map."""
    clicker = Clicker(gt)
    pred = np.zeros(gt.shape, bool)
    inner = getattr(ctl, "controller", ctl)
    recs, probs = [], []
    for _ in range(n):
        clicker.make_next_click(pred)
        c = clicker.clicks_list[-1]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if isinstance(ctl, FBRSController):
            ctl.interact(image, c.coords[1], c.coords[0], c.is_positive)
        else:
            ctl.add_click(c.coords[1], c.coords[0], c.is_positive)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        prob = inner.probs_history[-1][1]
        info = inner.predictor.last_info
        recs.append({"click": [c.coords[0], c.coords[1], c.is_positive],
                     "ms": ms, "recomputed": info["recomputed"],
                     "crop_hw": list(info["crop_hw"]), "iters": info["iters"],
                     "evals": info["evals"], "host_reads": info["host_reads"],
                     "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                  if dev.type == "cuda" else None)})
        probs.append(prob)
        pred = prob > 0.49
    return [(c.is_positive, c.coords) for c in clicker.clicks_list], recs, probs


def device_profile(fn):
    """torch.profiler over one call of fn (after one unprofiled call and
    a profiler warm-up): its wall ms, the kernels it launched, their
    summed device ms, the device's idle share of the wall time, and the
    kernels that took most device time."""
    fn()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [a for a in prof.key_averages()
            if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(a.self_device_time_total for a in rows) / 1e3
    top = sorted(rows, key=lambda a: -a.self_device_time_total)[:5]
    return {"wall_ms": wall_ms, "kernels": sum(a.count for a in rows),
            "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "top_device_ms": {a.key[:70]: a.self_device_time_total / 1e3
                              for a in top}}


def fbrs_gflop(crop_hw):
    """GFLOP of a click's work from shapes (torch.utils.flop_counter on
    meta tensors, batch 2 with the flip): the head input at the frame and
    at the crop, and one L-BFGS evaluation at the crop (gradients toward
    x only, as the predictor runs it)."""
    with torch.device("meta"):
        net = FBRSDeepLabModel("resnet50", ch=128).requires_grad_(False)
    rep = {}
    for name, (h, w) in (("frame", (RH, RW)), ("crop", tuple(crop_hw))):
        with FlopCounterMode(display=False) as fc:
            feats = net.head_input(torch.zeros(2, 3, h, w, device="meta"),
                                   torch.zeros(2, 2, 2, device="meta"))
        rep[f"head_input_gflop_{name}"] = fc.get_total_flops() / 1e9
    clicks = torch.zeros(1, 1, h, w, device="meta")
    _, loss_fn = fbrs_objective(net, feats, clicks, clicks, (h, w))
    x = torch.zeros(2 * feats.shape[1], device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(loss_fn(x)[0], x)
    rep["evaluation_gflop_crop"] = fc.get_total_flops() / 1e9
    return rep


def fbrs_breakdown(net, dev, image, clicks, crop_hw):
    """Where a click's time goes: GFLOP from shapes (fbrs_gflop), CUDA-event
    ms of the head input at the frame and at the ZoomIn crop, and of one
    L-BFGS evaluation (the head
    replay's forward and backward, the loss) at the crop; then
    torch.profiler traces of that evaluation and of the third click of a
    repeat drive (device_profile)."""
    h, w = crop_hw
    rep = fbrs_gflop(crop_hw)
    with torch.no_grad():
        for name, hw in (("head_input_ms_frame", (RH, RW)), ("head_input_ms_crop", (h, w))):
            img = torch.randn(2, 3, *hw, device=dev)
            pts = torch.tensor([[[hw[0] / 2, hw[1] / 2], [-1.0, -1.0]]] * 2, device=dev)
            rep[name] = cuda_ms(lambda: net.head_input(img, pts), iters=10)
        feats = net.head_input(torch.randn(2, 3, h, w, device=dev),
                               torch.full((2, 2, 2), -1.0, device=dev))
    pos = torch.zeros(1, 1, h, w, device=dev)
    neg = torch.zeros(1, 1, h, w, device=dev)
    pos[..., h // 2 - 1:h // 2 + 2, w // 2 - 1:w // 2 + 2] = 1
    neg[..., 10:13, 10:13] = 1
    _, loss_fn = fbrs_objective(net, feats, pos, neg, (h, w))
    x = torch.zeros(2 * feats.shape[1], device=dev, requires_grad=True)

    def evaluation():
        torch.autograd.grad(loss_fn(x)[0], x)

    rep["evaluation_ms_crop"] = cuda_ms(evaluation, iters=20)
    rep["evaluation"] = device_profile(evaluation)
    ctl = FBRSController(net, device=dev)
    for pos_, (y, x_) in clicks[:2]:
        ctl.interact(image, x_, y, pos_)
    (pos_, (y, x_)) = clicks[2]

    def click3():   # undone after, so both calls make the same third click
        ctl.interact(image, x_, y, pos_)
        ctl.undo()

    rep["click3"] = device_profile(click3)
    info = ctl.controller.predictor.last_info
    rep["click3"].update(iters=info["iters"], evals=info["evals"],
                         host_reads=info["host_reads"])
    return rep


def phase_fbrs(dev):
    """The f-BRS click path at full width (see the module docstring,
    phase 7). Runs with TF32 off, as main() sets."""
    net = fbrs_net()
    cpu_net = copy.deepcopy(net)
    frames, labels = synthetic_video(31, 1, RH, RW, 1)
    image, gt = frames[0], labels[0].astype(np.int32)
    rep = {"phase": "fbrs", "hw": [RH, RW], "model": "resnet50 ch128 fp32",
           "brs_mode": "f-BRS-B", "drives": {}}
    runs = {}
    for name in ("first_use", "repeat"):
        cmr.reset_launch_counts()   # the f-BRS path's launches start here
        ctl = FBRSController(net, device=dev)
        clicks, recs, probs = fbrs_drive(ctl, image, gt, FBRS_CLICKS, dev)
        counts = cmr.launch_counts()
        check(sum(counts.values()) == 0, f"f-BRS launched memory-read kernels {counts}")
        for i, p in enumerate(probs):
            check(p.shape == (RH, RW) and bool(np.isfinite(p).all())
                  and p.min() >= 0.0 and p.max() <= 1.0,
                  f"f-BRS {name} click {i}: map {p.shape} outside [0, 1] or not finite")
        check(recs[0]["iters"] == 0 and all(r["iters"] > 0 for r in recs[1:]),
              f"f-BRS {name}: the clicks after the first must optimize {recs}")
        for r in recs:
            log(json.dumps({"fbrs_click": name, **r}))
        rep["drives"][name] = {"ms": [r["ms"] for r in recs]}
        runs[name] = (ctl, clicks, probs, recs)
    ctl, clicks, probs, recs = runs["repeat"]
    check(all(runs[n][1] == clicks for n in runs), "f-BRS drives chose other clicks")
    mask = ctl.undo()
    check(np.array_equal(ctl.controller.probs_history[-1][1], probs[-2])
          and np.array_equal(mask, (probs[-2] > 0.5).astype(np.float32)),
          "undo did not restore the previous map")
    (y, x), pos = clicks[-1][1], clicks[-1][0]
    ctl.interact(image, x, y, pos)   # the undone click again, reported
    rep["redo_max_abs_dp"] = float(np.abs(ctl.controller.probs_history[-1][1]
                                          - probs[-1]).max())
    ctl.undo()
    ctl.controller.finish_object()
    result = ctl.controller.result_mask
    check(ctl.controller.object_count == 1
          and np.array_equal(result, (probs[-2] > 0.5).astype(np.uint8)),
          "finish_object did not commit the last map")
    gt_iou = [float((p > 0.49)[gt == 1].sum() / max(((p > 0.49) | (gt == 1)).sum(), 1))
              for p in probs]
    rep.update(clicks=clicks, iou_vs_gt_random_init=gt_iou,
               fg_fraction=[float((p > 0.49).mean()) for p in probs])

    # Card against CPU: the same weights and the user's clicks, at 240x320.
    full_image = image
    h, w, n = FBRS_CHECK
    frames, labels = synthetic_video(32, 1, h, w, 1)
    image, gt = frames[0], labels[0].astype(np.int32)
    out = []
    for d, m in ((dev, net), (torch.device("cpu"), cpu_net)):
        ctl = InteractiveController(m, prob_thresh=0.5, zoom_target=240, device=d)
        ctl.set_image(image)
        out.append(fbrs_drive(ctl, image, gt, n, d))
    (gc, grec, gp), (cc, crec, cp) = out
    gaps = [float(np.abs(a - b).max()) for a, b in zip(gp, cp)]
    ious = [float(((a > 0.49) & (b > 0.49)).sum() / max(((a > 0.49) | (b > 0.49)).sum(), 1))
            for a, b in zip(gp, cp)]
    rep["card_vs_cpu"] = {"hw": [h, w], "clicks": gc, "max_abs_dp": gaps,
                          "mask_iou": ious, "cpu_clicks": cc,
                          "iters_card": [r["iters"] for r in grec],
                          "iters_cpu": [r["iters"] for r in crec]}
    log(json.dumps(rep))
    check(gaps[0] <= 1e-3, f"f-BRS first click card vs CPU {gaps[0]} > 1e-3")
    check(gc == cc, f"f-BRS card and CPU chose other clicks: {gc} vs {cc}")
    check(min(ious[1:]) >= 0.99, f"f-BRS card vs CPU mask IoU {ious}")
    crop = next(r["crop_hw"] for r in recs if r["iters"])
    log(json.dumps({"fbrs_breakdown": fbrs_breakdown(net, dev, full_image, clicks, crop)}))
    repeat = rep["drives"]["repeat"]["ms"]
    log(json.dumps({"metric": "fbrs_click_ms_480p", "first_click_ms": repeat[0],
                    "repeat_ms": repeat, "optimized_median_ms": float(np.median(repeat[1:])),
                    "first_use_ms": rep["drives"]["first_use"]["ms"]}))


def predictor_drive(pred, image, gt, n, dev):
    """n clicks of the NoC user (Clicker over gt, the mask p > 0.49)
    through a predictor (get_predictor's or TiledPredictor) on a fresh
    image. Returns the clicks, each click's record and map."""
    pred.set_input_image(image)
    clicker = Clicker(gt)
    mask = np.zeros(gt.shape, bool)
    recs, maps = [], []
    for _ in range(n):
        clicker.make_next_click(mask)
        c = clicker.clicks_list[-1]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prob = pred.get_prediction(clicker)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        prob = prob.cpu().numpy()
        info = dict(getattr(pred, "last_info", {}))
        recs.append({"click": [c.coords[0], c.coords[1], c.is_positive], "ms": ms,
                     "crop_hw": list(info.get("crop_hw", prob.shape)),
                     "iters": info.get("iters", 0), "evals": info.get("evals", 0),
                     "host_reads": info.get("host_reads", 0),
                     "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                  if dev.type == "cuda" else None)})
        maps.append(prob)
        mask = prob > 0.49
    return [(c.is_positive, c.coords) for c in clicker.clicks_list], recs, maps


def check_maps(maps, hw, what):
    for i, p in enumerate(maps):
        check(p.shape == tuple(hw) and bool(np.isfinite(p).all())
              and p.min() >= 0.0 and p.max() <= 1.0,
              f"{what} click {i}: map {p.shape} outside [0, 1] or not finite")


def check_optimized(recs, what):
    """As in JAX: the first click runs the network alone, every later
    click optimizes."""
    check(recs[0]["iters"] == 0 and all(r["iters"] > 0 for r in recs[1:]),
          f"{what}: the clicks after the first must optimize "
          f"{[r['iters'] for r in recs]}")


def fbrs_hrnet_net(dev_image):
    """Random-init FBRSHRNetModel(32, 128) (the f-BRS release's
    hrnet32_ocr128) from a seed, on the host, with non-trivial frozen-BN
    statistics (weight and running_var uniform in [0.5, 1.5], bias and
    running_mean normal with deviation 0.1, as the CPU tests' random
    trees), its cls_head rescaled so that its logits on `dev_image` (the
    frame, with one centre click) have median 0 and deviation 2: a random
    OCR head otherwise saturates every pixel."""
    gen = torch.Generator().manual_seed(12)
    net = init_params(FBRSHRNetModel(32, 128, small=False, norm_radius=260.0), gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, FrozenBatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
        image = torch.from_numpy(dev_image).permute(2, 0, 1)[None]
        h, w = dev_image.shape[:2]
        z = net.eval()(image, torch.tensor([[[h / 2, w / 2], [-1.0, -1.0]]]))
        a = 2.0 / float(z.std())
        head = net.feature_extractor.cls_head
        head.weight.mul_(a)
        head.bias.mul_(a).sub_(a * float(z.median()))
    return net


def oracle_objective(pred, x):
    """The oracle's objective (BCE to the ground truth cut to the crop, and
    the scale/bias regularizer) at x for the predictor's cached head
    input."""
    hw = tuple(pred.last_info["crop_hw"])
    predict, c = _scaled_predict(pred.net, pred.insertion_mode, pred.input_data, hw)
    gt = pred._oracle_gt_for_crop(hw)
    gt2 = torch.cat([gt, torch.flip(gt, dims=[-1])])
    with torch.no_grad():
        loss = sigmoid_bce_from_probs(torch.sigmoid(predict(x)), gt2).mean()
        return float(loss), float(loss + _scale_bias_reg(x, c))


def mask_iou(a, b):
    """IoU of two boolean masks; two empty masks agree (1)."""
    union = int((a | b).sum())
    return float((a & b).sum() / union) if union else 1.0


def card_vs_cpu(make_pred, net, image, gt, n, dev):
    """The same weights and the NoC user's clicks through make_pred(net,
    device) on the card and on a CPU copy: the first map's max |dp|, the
    clicks, each map's mask (p > 0.49) IoU."""
    out = []
    for d, m in ((dev, net), (torch.device("cpu"), copy.deepcopy(net).cpu())):
        out.append(predictor_drive(make_pred(m, d), image, gt, n, d))
    (gc, grec, gp), (cc, crec, cp) = out
    rep = {"clicks": gc, "cpu_clicks": cc,
           "max_abs_dp": [float(np.abs(a - b).max()) for a, b in zip(gp, cp)],
           "mask_iou": [mask_iou(a > 0.49, b > 0.49) for a, b in zip(gp, cp)],
           "iters_card": [r["iters"] for r in grec],
           "iters_cpu": [r["iters"] for r in crec],
           "cpu_s": sum(r["ms"] for r in crec) / 1e3}
    return rep


def phase_fbrs_modes(dev):
    """The rest of the f-BRS click path at full width (module docstring,
    phase 8). TF32 off, as main() sets; main() runs it under
    deterministic cuDNN plans."""
    frames, labels = synthetic_video(31, 1, RH, RW, 1)
    image, gt = frames[0], labels[0].astype(np.int32)
    zoom = {"target_size": 480, "expansion_ratio": 1.4}
    params = {"maxiter": 20}
    rep = {"phase": "fbrs_modes", "hw": [RH, RW], "deeplab": {}, "hrnet": {}}
    cmr.reset_launch_counts()   # no launch in the whole phase
    t_phase = time.perf_counter()

    # DeepLab R50 ch128 (resnet50_dh128_lvis) under the four new modes.
    net = fbrs_net()
    for mode in FBRS_NEW_MODES:
        runs = {}
        for name in ("first_use", "repeat"):
            pred = get_predictor(net, mode, zoom_in_params=zoom,
                                 predictor_params=params, device=dev)
            clicks, recs, maps = predictor_drive(pred, image, gt, FBRS_CLICKS, dev)
            check_maps(maps, (RH, RW), f"{mode} {name}")
            check_optimized(recs, f"{mode} {name}")
            runs[name] = (clicks, recs)
        check(runs["first_use"][0] == runs["repeat"][0],
              f"{mode}: the two drives chose other clicks")
        clicks, recs = runs["repeat"]
        for r in recs:
            log(json.dumps({"fbrs_mode_click": mode, "model": "resnet50 ch128", **r}))
        rep["deeplab"][mode] = {
            "first_click_ms": recs[0]["ms"],
            "optimized_median_ms": float(np.median([r["ms"] for r in recs[1:]])),
            "ms": [r["ms"] for r in recs],
            "first_use_ms": [r["ms"] for r in runs["first_use"][1]],
            "iters": [r["iters"] for r in recs], "evals": [r["evals"] for r in recs],
            "crop_hw": recs[-1]["crop_hw"],
            "peak_gib": max(r["peak_gib"] or 0.0 for r in recs),
            "iou_vs_gt_random_init": [float(((m > 0.49) & (gt == 1)).sum()
                                            / max(((m > 0.49) | (gt == 1)).sum(), 1))
                                      for m in maps]}

    # The oracle on the same net: at each optimized click the objective
    # at the returned x is no higher than at the x it started from.
    pred = get_predictor(net, "f-BRS-B", zoom_in_params=zoom, predictor_params=params,
                         device=dev)
    pred.set_input_image(image)
    pred.set_oracle_gt(gt)
    clicker, mask, oracle = Clicker(gt), np.zeros(gt.shape, bool), []
    for i in range(3):
        clicker.make_next_click(mask)
        x0 = None if pred.opt_data is None else pred.opt_data.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prob = pred.get_prediction(clicker)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        prob = prob.cpu().numpy()
        check_maps([prob], (RH, RW), "oracle")
        iters = pred.last_info["iters"]
        check((iters > 0) == (i > 0), f"oracle click {i}: {iters} iterations")
        rec = {"click": i, "ms": ms, "iters": iters,
               "iou_vs_gt": float(((prob > 0.49) & (gt == 1)).sum()
                                  / max(((prob > 0.49) | (gt == 1)).sum(), 1))}
        if iters:
            at_x0 = oracle_objective(pred, x0)
            at_x = oracle_objective(pred, pred.opt_data)
            rec.update(loss_x0=at_x0[0], loss_x=at_x[0], objective_x0=at_x0[1],
                       objective_x=at_x[1])
            check(at_x[1] <= at_x0[1], f"oracle objective rose {rec}")
        oracle.append(rec)
        mask = prob > 0.49
    rep["oracle"] = oracle

    # TiledPredictor: 4 crops of 320x480 and their flips, one batch of 8.
    tiled = TiledPredictor(net, crop_size=TILE_CROP, device=dev)
    _, recs, maps = predictor_drive(tiled, image, gt, 2, dev)
    check_maps(maps, (RH, RW), "tiled")
    check(len(tiled.crops.offsets) == 4, f"tiled crops {tiled.crops.offsets}")
    rep["tiled"] = {"crop_hw": list(TILE_CROP), "crops": len(tiled.crops.offsets),
                    "batch": 2 * len(tiled.crops.offsets),
                    "click_ms": recs[-1]["ms"], "first_click_ms": recs[0]["ms"],
                    "peak_gib": recs[-1]["peak_gib"]}
    del tiled, pred

    # HRNet-W32-OCR128.
    hnet = fbrs_hrnet_net(image).to(dev)
    with torch.no_grad():
        img = torch.from_numpy(np.stack([image, image[:, ::-1]])).permute(0, 3, 1, 2).to(dev)
        pts = torch.tensor([[[RH / 2, RW / 2], [-1.0, -1.0]]] * 2, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rep["hrnet"]["head_input_ms_frame"] = cuda_ms(lambda: hnet.head_input(img, pts))
        rep["hrnet"]["head_input_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rep["hrnet"]["head_input_shape"] = list(hnet.head_input(img, pts).shape)
    for mode in HRNET_MODES:
        runs = {}
        for name in ("first_use", "repeat"):
            pred = get_predictor(hnet, mode, zoom_in_params=zoom,
                                 predictor_params=params, device=dev)
            clicks, recs, maps = predictor_drive(pred, image, gt, FBRS_CLICKS, dev)
            check_maps(maps, (RH, RW), f"hrnet {mode} {name}")
            if mode != "NoBRS":
                check_optimized(recs, f"hrnet {mode} {name}")
            runs[name] = (clicks, recs)
        clicks, recs = runs["repeat"]
        for r in recs:
            log(json.dumps({"fbrs_mode_click": mode, "model": "hrnet32 ocr128", **r}))
        rep["hrnet"][mode] = {
            "insertion": pred.insertion_mode, "first_click_ms": recs[0]["ms"],
            "optimized_median_ms": float(np.median([r["ms"] for r in recs[1:]])),
            "ms": [r["ms"] for r in recs],
            "first_use_ms": [r["ms"] for r in runs["first_use"][1]],
            "iters": [r["iters"] for r in recs], "evals": [r["evals"] for r in recs],
            "peak_gib": max(r["peak_gib"] or 0.0 for r in recs)}
    counts = cmr.launch_counts()
    check(sum(counts.values()) == 0, f"f-BRS modes launched memory-read kernels {counts}")
    rep["memory_read_launches"] = sum(counts.values())
    rep["drives_s"] = time.perf_counter() - t_phase

    # Card against CPU at 240x320: the same weights and clicks.
    h, w, n = FBRS_CHECK
    frames, labels = synthetic_video(32, 1, h, w, 1)
    small, sgt = frames[0], labels[0].astype(np.int32)
    szoom = {"target_size": 240, "expansion_ratio": 1.4}
    rep["card_vs_cpu"] = {"hw": [h, w]}
    for family, model, modes in (("deeplab", net, FBRS_NEW_MODES),
                                 ("hrnet", hnet, ("f-BRS-B", "f-BRS-C"))):
        for mode in modes:
            r = card_vs_cpu(lambda m, d: get_predictor(m, mode, zoom_in_params=szoom,
                                                        predictor_params=params, device=d),
                            model, small, sgt, n, dev)
            rep["card_vs_cpu"][f"{family} {mode}"] = r
            log(json.dumps({"fbrs_modes_card_vs_cpu": f"{family} {mode}", **r}))
    for key, r in rep["card_vs_cpu"].items():
        if key != "hw":
            check(r["max_abs_dp"][0] <= 1e-3,
                  f"{key} first click card vs CPU {r['max_abs_dp'][0]} > 1e-3")
            check(r["clicks"] == r["cpu_clicks"], f"{key}: card and CPU chose other clicks")
            check(min(r["mask_iou"][1:]) >= 0.99, f"{key} card vs CPU mask IoU {r['mask_iou']}")
    counts = cmr.launch_counts()
    check(sum(counts.values()) == 0, f"f-BRS modes launched memory-read kernels {counts}")
    rep["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps(rep))
    for family in ("deeplab", "hrnet"):
        for mode, r in rep[family].items():
            if isinstance(r, dict):
                log(json.dumps({"metric": "fbrs_click_ms_480p", "model": family,
                                "brs_mode": mode, "first_click_ms": r["first_click_ms"],
                                "optimized_median_ms": r["optimized_median_ms"]}))


def uint8_video(seed, t, h, w, k):
    """synthetic_video's frames as uint8 RGB (what a client uploads) and
    its label maps as uint8."""
    frames, labels = synthetic_video(seed, t, h, w, k)
    rgb = np.clip(frames * STD + MEAN, 0.0, 1.0) * 255.0
    return np.round(rgb).astype(np.uint8), labels.astype(np.uint8)


def http(url, method="GET", arrays=None):
    """One request to the server: (status, decoded JSON or npz body)."""
    data = None
    if arrays is not None:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        data = buf.getvalue()
    req = urllib.request.Request(url, data, method=method)
    with urllib.request.urlopen(req) as r:
        body = r.read()
        if r.headers["Content-Type"] == "application/json":
            return r.status, json.loads(body)
    with np.load(io.BytesIO(body)) as z:
        return 200, {k: z[k] for k in z.files}


def phase_serve(dev):
    """The HTTP session server (module docstring, phase 9). Returns the
    launch counts of the served interactions."""
    t_phase = time.perf_counter()
    prop, fuse = make_nets(dev, BF16)
    mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ)
    mgr = SessionManager(prop, fuse, mem=mem, devices=[dev], max_sessions=2)
    del prop, fuse
    warm_s = mgr.warm(T, RH, RW, K, interactions=2)
    log(f"serve: warm {warm_s:.3f} s (T={T}, {RH}x{RW}, K={K}, 2 rounds)")
    srv = make_server(mgr, port=0)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    base = "http://%s:%d" % srv.server_address[:2]
    video_a, lab_a = uint8_video(41, T, RH, RW, K)
    video_b, lab_b = uint8_video(42, T, RH, RW, K)
    rounds_a = [(0, lab_a[0]), (T - 1, lab_a[T - 1]), (T // 2, lab_a[T // 2])]
    rep = {"phase": "serve", "video": [T, RH, RW, K], "warm_s": warm_s,
           "interact_ms": []}

    def interact(sid, idx, labels):
        t0 = time.perf_counter()
        _, body = http(f"{base}/v1/sessions/{sid}/interact", "POST",
                       {"labels": labels, "frame": np.int64(idx)})
        return body["masks"], (time.perf_counter() - t0) * 1e3

    cmr.reset_launch_counts()   # the serve path's launches start here
    reads = 0
    t0 = time.perf_counter()
    _, body = http(f"{base}/v1/sessions?num_objects={K}", "POST",
                   {"video": video_a})
    rep["create_ms"] = (time.perf_counter() - t0) * 1e3
    sid_a = body["session_id"]
    core_a = mgr._get(sid_a).core

    # Round 1 while a second client polls /progress every 10 ms. The
    # session's chunk hook is wrapped for this round to time when the
    # server first hands a chunk over, apart from the poll's reply.
    polls, stop, handed = [], threading.Event(), []

    def hooked(mask, idx, chunk_cb):
        def cb(tis, labs):
            handed.append(time.perf_counter())
            chunk_cb(tis, labs)
        return type(core_a).interact(core_a, mask, idx, chunk_cb=cb)

    core_a.interact = hooked

    def poll():
        while not stop.is_set():
            _, p = http(f"{base}/v1/sessions/{sid_a}/progress")
            polls.append((time.perf_counter(), int(p["round"]), int(p["done"]),
                          len(p["frames"])))
            time.sleep(0.01)

    poller = threading.Thread(target=poll)
    reads += reads_of(core_a, 0)
    t_start = time.perf_counter()
    poller.start()
    served = [interact(sid_a, *rounds_a[0])]
    del core_a.interact
    stop.set()
    poller.join(60.0)
    check(not poller.is_alive(), "the progress poller did not stop")
    streaming = [n for _, rnd, done, n in polls if rnd == 1 and not done]
    check(any(1 <= n <= T - 2 for n in streaming),
          f"no poll saw a partial round: {[(r, d, n) for _, r, d, n in polls]}")
    # first_chunk_ms: the first /progress reply with frames, as a client
    # sees it (the reply's npz encode included); first_chunk_cb_ms: the
    # server's first chunk hand-over, both from before the request.
    rep["first_chunk_ms"] = min(
        (t - t_start) * 1e3 for t, rnd, _, n in polls if rnd == 1 and n > 0)
    rep["first_chunk_cb_ms"] = (handed[0] - t_start) * 1e3
    rep["chunks"] = len(handed)
    rep["polls"], rep["partial_polls"] = len(polls), len(streaming)
    reads += reads_of(core_a, T - 1)
    served.append(interact(sid_a, *rounds_a[1]))   # the fusion pass
    _, body = http(f"{base}/v1/sessions/{sid_a}/masks")
    check(np.array_equal(body["masks"], served[-1][0]),
          "GET /masks differs from the last interact's masks")

    # Two sessions, two clients at once: A's frame 30 and B's frame 0.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, body = http(f"{base}/v1/sessions?num_objects={K}", "POST",
                   {"video": video_b})
    sid_b = body["session_id"]
    reads += reads_of(core_a, rounds_a[2][0])
    reads += reads_of(mgr._get(sid_b).core, 0)
    both = {}
    clients = [threading.Thread(target=lambda: both.update(
                   a=interact(sid_a, *rounds_a[2]))),
               threading.Thread(target=lambda: both.update(
                   b=interact(sid_b, 0, lab_b[0])))]
    for c in clients:
        c.start()
    for c in clients:
        c.join(300.0)
    check(not any(c.is_alive() for c in clients) and set(both) == {"a", "b"},
          "a concurrent interact did not finish")
    torch.cuda.synchronize()
    rep["peak_gib_two_sessions"] = torch.cuda.max_memory_allocated() / 2**30
    counts = cmr.launch_counts()
    check(counts == {name: n * reads for name, n in
                     cmr.launches_per_read(BF16, 0).items()},
          f"serve launches {counts} for {reads} reads")
    rep["interact_ms"] = [ms for _, ms in served] + [both["a"][1], both["b"][1]]
    rep["reads"] = reads
    # Where a round's time goes besides the manager's interact (its own
    # latencies, the 2 warm rounds first): the masks' npz on the wire.
    rep["manager_interact_s"] = list(mgr._latencies)
    t0 = time.perf_counter()
    buf = io.BytesIO()
    np.savez_compressed(buf, masks=served[-1][0])
    rep["npz_encode_ms"] = (time.perf_counter() - t0) * 1e3
    rep["npz_mb"] = len(buf.getvalue()) / 1e6
    t0 = time.perf_counter()
    np.load(io.BytesIO(buf.getvalue()))["masks"]
    rep["npz_decode_ms"] = (time.perf_counter() - t0) * 1e3

    # The same interactions through direct cores on the same prepared nets.
    prop, fuse = mgr.prepared_nets(dev)
    ref = InferenceCore(prop, fuse, video_a, K, mem=mem, device=dev)
    for (idx, lab), (masks, _) in zip(rounds_a, served + [both["a"]]):
        check(np.array_equal(ref.interact(labels_to_probs(lab, K), idx), masks),
              f"served session A, frame {idx}: labels differ from a direct core")
    ref = InferenceCore(prop, fuse, video_b, K, mem=mem, device=dev)
    check(np.array_equal(ref.interact(labels_to_probs(lab_b[0], K), 0),
                         both["b"][0]),
          "served session B: labels differ from a direct core")
    del ref
    session_invariants(core_a, both["a"][0])

    _, metrics = http(f"{base}/metrics")
    check(metrics["interactions"] == 2 + 4 and metrics["created"] == 1 + 2,
          f"/metrics {metrics}")
    rep["metrics"] = metrics   # p50/p95 over the 2 warm and 4 served rounds
    for sid in (sid_a, sid_b):
        check(http(f"{base}/v1/sessions/{sid}", "DELETE")[1] == {"closed": True},
              f"DELETE {sid}")
    check(shutdown_gracefully(srv, timeout=60.0), "shutdown did not drain")
    server.join(10.0)
    check(len(mgr) == 0 and not server.is_alive(), "sessions left after shutdown")
    rep["wall_s"] = time.perf_counter() - t_phase
    log(json.dumps(rep))
    return counts


def phase_gui(dev):
    """The headless GUI session (module docstring, phase 10). Returns the
    launch counts of its propagations."""
    t_phase = time.perf_counter()
    k = 2
    video, labels = uint8_video(43, T, RH, RW, k)
    prop, fuse = make_nets(dev, BF16)
    s2m = init_params(S2MNetwork(dtype=BF16), torch.Generator().manual_seed(5))
    mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ)
    gui = GuiSession(prop, fuse, S2MController(s2m, k, device=dev),
                     FBRSController(fbrs_net(), device=dev), video, k,
                     mem=mem, device=dev)
    del prop, fuse
    core = gui.processor
    calls, reads = [], []   # what the session hands the processor, in order
    orig_interact, orig_update = core.interact, core.update_mask_only

    def interact(mask, idx, **hooks):
        calls.append(("interact", mask.clone(), idx))
        reads.append(reads_of(core, idx))
        return orig_interact(mask, idx, **hooks)

    def update_mask_only(mask, idx):
        calls.append(("update", mask.clone(), idx))
        return orig_update(mask, idx)

    core.interact, core.update_mask_only = interact, update_mask_only
    rep = {"phase": "gui", "video": [T, RH, RW, k], "propagation_s": []}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def stroke(mode, points, arg):
        gui.start_interaction(mode)
        for x, y in points:
            gui.push_point(x, y, arg)
        gui.end_path()

    def propagate(want):
        total, steps = [], []
        _, ms = timed(lambda: gui.run_propagation(
            total_cb=total.append, step_cb=lambda: steps.append(1)))
        check(total == [want] and len(steps) == want,
              f"propagation: total {total}, {len(steps)} steps, want {want}")
        rep["propagation_s"].append(ms / 1e3)

    def centre(ti, obj):
        ys, xs = np.nonzero(labels[ti] == obj)
        return float(xs.mean()), float(ys.mean())

    cmr.reset_launch_counts()   # the gui path's launches start here
    # Frame 0: scribbles for both objects, S2M; two free strokes, undo one.
    for obj in (1, 2):
        x, y = centre(0, obj)
        stroke("scribble", [(x - 40, y - 20), (x, y), (x + 40, y + 20)], obj)
    _, rep["s2m_predict_ms"] = timed(gui.predict)
    check(set(np.unique(gui.current_mask())) <= {0, 1, 2}, "S2M labels")
    x, y = centre(0, 1)
    stroke("free", [(x - 30, y), (x + 30, y)], 1)
    first = gui.predict().copy()
    stroke("free", [(x, y - 30), (x, y + 30)], 2)
    gui.predict()
    check(gui.undo() and np.array_equal(gui.current_mask(), first),
          "free undo did not restore the first stroke's labels")
    propagate(T - 1)
    # Frame 40: a positive and a negative click on object 1, undo one;
    # a click on object 2; the fusion pass back to frame 1.
    f40, f20 = 2 * T // 3, T // 3
    gui.goto(f40)
    gui.current_object = 1
    x, y = centre(f40, 1)
    gui.start_interaction("click")
    rep["click_ms"] = []
    for cx, cy, neg in ((x, y, False),
                        (min(x + 60, RW - 1), min(y + 60, RH - 1), True)):
        _, ms = timed(lambda: gui.push_point(cx, cy, neg))
        rep["click_ms"].append(ms)
        gui.predict()
        if not neg:
            after_first = gui.current_mask().copy()
    check(gui.undo() and np.array_equal(gui.current_mask(), after_first),
          "click undo did not restore the first click's labels")
    gui.set_object(2)
    x, y = centre(f40, 2)
    gui.start_interaction("click")
    _, ms = timed(lambda: gui.push_point(x, y, False))
    rep["click_ms"].append(ms)
    gui.predict()
    propagate((T - 1 - f40) + (f40 - 1))
    # Frame 20: local control on a 200x150 box, a free stroke inside.
    gui.goto(f20)
    gui.enter_local((RW // 2 - 100, RW // 2 + 99, RH // 2 - 75, RH // 2 + 74))
    stroke("free", [(20, 20), (180, 130)], 1)
    gui.predict()
    check(gui.compose_local_frame().shape == (150, 200, 3), "local canvas")
    gui.finish_local()
    propagate((f40 - f20 - 1) + (f20 - 1))
    counts = cmr.launch_counts()
    check(counts == {name: n * sum(reads) for name, n in
                     cmr.launches_per_read(BF16, 0).items()},
          f"gui launches {counts} for {sum(reads)} reads")
    rep["reads"] = sum(reads)

    for mode in ("davis", "fade", "light"):
        gui.viz_mode = mode
        viz = gui.compose_frame()
        check(viz.shape == (RH, RW, 3) and viz.dtype == np.uint8, f"{mode} frame")
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        gui.save_masks(tmp)
        names = sorted(os.listdir(tmp))
        check(len(names) == T, f"{len(names)} mask files")
        for ti, name in enumerate(names):
            check(np.array_equal(np.asarray(Image.open(os.path.join(tmp, name))),
                                 core.np_masks[ti]), f"saved mask {name}")
    session_invariants(core, core.np_masks)

    # The masks the session handed the processor, through a direct core.
    ref = InferenceCore(core.prop_net, core.fuse_net, video, k, mem=mem,
                        device=dev)
    for kind, mask, idx in calls:
        (ref.interact if kind == "interact" else ref.update_mask_only)(mask, idx)
    check(np.array_equal(ref.np_masks, core.np_masks),
          "the GUI session's labels differ from a direct core's")
    rep["processor_calls"] = [(kind, idx) for kind, _, idx in calls]
    rep["wall_s"] = time.perf_counter() - t_phase
    log(json.dumps(rep))
    return counts



def write_davis_tree(root):
    """A DAVIS-layout tree (trainval/JPEGImages/480p, Annotations/480p,
    ImageSets/2017/train.txt) of FG_VIDEOS: GEN_T-frame RHxRW JPEG
    videos and palette PNG annotations, K objects each (0: none usable).
    Returns the video names."""
    from PIL import Image

    from mivos_tpu_torch.utils.palette import save_indexed_png

    base = os.path.join(root, "trainval")
    names = []
    for seed, k in FG_VIDEOS:
        name = f"vid{seed}_k{k}"
        names.append(name)
        video, labels = uint8_video(seed, GEN_T, RH, RW, k)
        for sub in ("JPEGImages", "Annotations"):
            os.makedirs(os.path.join(base, sub, "480p", name))
        for f in range(GEN_T):
            Image.fromarray(video[f]).save(os.path.join(
                base, "JPEGImages", "480p", name, f"{f:05d}.jpg"), quality=95)
            save_indexed_png(os.path.join(base, "Annotations", "480p", name,
                                          f"{f:05d}.png"), labels[f])
    os.makedirs(os.path.join(base, "ImageSets", "2017"))
    with open(os.path.join(base, "ImageSets", "2017", "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names


@contextlib.contextmanager
def timed_calls(owner, name, totals):
    """Adds the host seconds of every call of owner.<name> (which must
    end in a host copy or write) to totals[name] within the block."""
    orig = getattr(owner, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0

    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, orig)


class _Stamped(io.TextIOBase):
    """stdout that keeps each line with the perf_counter time it ended."""

    def __init__(self):
        self.lines, self._buf = [], ""

    def write(self, text):
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(text)


def usable_objects(gt, frame):
    """generate_fusion's rule: objects with more than 100 pixels on the
    frame, at most 5."""
    return [k for k in range(gt.shape[0])
            if (gt[k, frame] > 0.5).sum() > generate_fusion.MIN_PIXELS
            ][:generate_fusion.MAX_OBJECTS]


def phase_fusion_gen(dev, tmp):
    """python -m mivos_tpu_torch.generate_fusion in process (module
    docstring, phase 11). Returns the launch counts of its run, the
    tree's root, the fusion-data root and the weights file."""
    from PIL import Image

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "davis")
    names = write_davis_tree(root)
    net = init_params(PropagationNetwork(), torch.Generator().manual_seed(0))
    pth = os.path.join(tmp, "propagation_model.pth")
    torch.save(net.state_dict(), pth)   # reference names: loads as the .pth
    del net
    fd_root = os.path.join(tmp, "fusion_data")
    out = os.path.join(fd_root, "davis")
    argv = ["--dataset", "DAVIS", "--davis_root", root, "--output", out,
            "--separation", str(GEN_SEPARATION), "--model", pth,
            "--device", str(dev)]
    dataset = DAVISTestDataset(os.path.join(root, "trainval"), imset="2017/train.txt")
    plan = {}   # video -> (reference frames, usable objects on each)
    for i, name in enumerate(dataset.videos):
        gt = dataset[i]["gt"]
        plan[name] = [(f, usable_objects(gt, f))
                      for f in range(0, GEN_T, GEN_SEPARATION)]
        plan[name] = [(f, objs) for f, objs in plan[name] if objs]
    reads = sum(len(refs) * (GEN_T - 1) for refs in plan.values())

    cmr.reset_launch_counts()   # the fusion_gen path's launches start here
    stamped, split, read_shapes = _Stamped(), {}, set()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stamped), \
            timed_calls(FusionGenerator, "interact_mask", split), \
            timed_calls(generate_fusion, "_save_png", split), \
            recorded_read_shapes(read_shapes):
        generate_fusion.main(argv)
    torch.cuda.synchronize()
    counts = cmr.launch_counts()
    check(counts == {name: n * reads for name, n in
                     cmr.launches_per_read(BF16, 0).items()},
          f"fusion_gen launches {counts} for {reads} reads")
    check([line for _, line in stamped.lines] == names + ["ALL-DONE"],
          f"generate_fusion printed {stamped.lines}")
    rep = {"phase": "fusion_gen", "videos": {}, "reads": reads,
           "separation": GEN_SEPARATION, "frames": GEN_T, "hw": [RH, RW]}
    prev = t0
    for (stamp, name) in stamped.lines[:len(names)]:
        refs = plan[name]
        pngs = [os.path.join(d, f) for d, _, files in
                os.walk(os.path.join(out, name)) for f in files]
        want = sum(len(objs) for _, objs in refs) * GEN_T
        check(len(pngs) == want, f"{name}: {len(pngs)} PNGs, want {want}")
        if not refs:
            check(os.listdir(os.path.join(out, name)) == [],
                  f"{name} has no usable object but its directory is not empty")
        rep["videos"][name] = {
            "K": [len(objs) for _, objs in refs], "refs": len(refs),
            "seconds": stamp - prev, "pngs": len(pngs),
            "propagated_frames_s": len(refs) * (GEN_T - 1) / (stamp - prev)}
        prev = stamp
    check(sorted(os.listdir(out)) == sorted(names), f"outputs {os.listdir(out)}")
    rep["seconds"] = prev - t0
    # Where the run's time went: propagation (interact_mask, ending in its
    # download), PNG writes, and the rest (decoding the videos, the net).
    rep["interact_mask_s"], rep["png_write_s"] = split["interact_mask"], split["_save_png"]

    # One reference frame through a direct FusionGenerator on the same net.
    name = names[0]
    ref_frame, objs = plan[name][min(1, len(plan[name]) - 1)]
    data = dataset[0]
    direct = PropagationNetwork(dtype=BF16)
    direct.load_state_dict(torch.load(pth, weights_only=True))
    gen = FusionGenerator(direct, data["rgb"], mem_freq=MEM_FREQ, device=dev)
    gen.reset(len(objs))
    probs = gen.interact_mask(data["gt"][objs, ref_frame], ref_frame, 0, GEN_T - 1)
    worst = 0
    for ki, obj in enumerate(objs):
        want = (probs[ki + 1] * 255).astype(np.uint8).astype(np.int16)
        for f in range(GEN_T):
            got = np.asarray(Image.open(os.path.join(
                out, name, f"{ref_frame:05d}", f"{obj + 1:05d}", f"{f:05d}.png")),
                np.int16)
            worst = max(worst, int(np.abs(got - want[f]).max()))
    rep["direct_max_uint8_diff"] = worst
    check(worst <= 1, f"generate_fusion vs a direct FusionGenerator: {worst} levels")

    cmr.reset_launch_counts()
    stamped = _Stamped()
    with contextlib.redirect_stdout(stamped):
        generate_fusion.main(argv + ["--skip_done"])
    check(sum(cmr.launch_counts().values()) == 0, "--skip_done launched kernels")
    check(sum("(skipped)" in line for _, line in stamped.lines) == len(names),
          f"--skip_done printed {stamped.lines}")
    check(not [d for d in os.listdir(out) if d.endswith(".__tmp__")],
          "staging directories left")
    rep["wall_s"] = time.perf_counter() - t_phase
    rep["read_shapes"] = len(read_shapes)
    log(json.dumps(rep))
    check(len(read_shapes) > 0, "no read shape recorded")
    return counts, read_shapes, root, fd_root, pth


def phase_train(dev, tmp, root, fd_root, pth):
    """FusionDataset, Loader and FusionTrainer on the card over phase 11's
    output (module docstring, phase 12)."""
    t_phase = time.perf_counter()
    im_root = os.path.join(root, "trainval", "JPEGImages", "480p")
    gt_root = os.path.join(root, "trainval", "Annotations", "480p")
    cfg = TrainConfig(iterations=TRAIN_STEPS, steps=(TRAIN_STEPS // 2,),
                      batch_size=TRAIN_BATCH)
    dataset = FusionDataset(im_root, gt_root, fd_root, seed=cfg.seed)
    check(len(dataset) == sum(k > 0 for _, k in FG_VIDEOS),
          f"{len(dataset)} training videos")
    # A sampler over more indices than videos: sample idx draws video
    # idx % len in its first trials, so each batch holds 12 samples.
    sampler = ShardedSampler(TRAIN_BATCH * (TRAIN_STEPS + 2), seed=cfg.seed)
    loader = Loader(dataset, TRAIN_BATCH, sampler=sampler, num_workers=8,
                    pin_memory=True)
    attn = attention_read_state_dict(pth)
    trainer = FusionTrainer(cfg, attn, device=dev)
    rep = {"phase": "train", "batch": TRAIN_BATCH, "crop": FusionDataset.CROP,
           "steps": TRAIN_STEPS, "lr_drop_at": TRAIN_STEPS // 2}
    batches = iter(loader)
    step_ms, device_ms, wait_ms, losses, lrs = [], [], [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats(dev)
    with cudnn_mode(benchmark=True):   # training's setting: fixed shapes
        for i in range(TRAIN_STEPS + 1):   # step 0 warms up
            t0 = time.perf_counter()
            if i == 1:
                window_t0 = t0   # the measured window starts here
            batch = next(batches)
            t1 = time.perf_counter()
            lrs.append(trainer.lr)
            start.record()
            out = trainer.train_step(batch)
            end.record()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            losses.append(float(out["total_loss"]))
            if i:
                wait_ms.append((t1 - t0) * 1e3)
                step_ms.append((t2 - t1) * 1e3)
                device_ms.append(start.elapsed_time(end))
    window_s = time.perf_counter() - window_t0
    batches.close()
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    drop = TRAIN_STEPS // 2
    check(all(lr == cfg.lr for lr in lrs[:drop]) and
          all(abs(lr - cfg.lr * cfg.gamma) < 1e-12 for lr in lrs[drop:]),
          f"learning rates {lrs}")
    med = float(np.median(step_ms))
    # The rates: all the measured window's work (loader waits and steps)
    # over its wall time; the medians are per-layer numbers.
    rep.update({
        "losses": losses, "lr": lrs, "step_ms": step_ms, "wait_ms": wait_ms,
        "window_s": window_s,
        "steps_s": TRAIN_STEPS / window_s,
        "samples_s": TRAIN_STEPS * TRAIN_BATCH / window_s,
        "median_step_ms": med, "median_device_ms": float(np.median(device_ms)),
        "median_wait_ms": float(np.median(wait_ms)),
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30})

    with cudnn_mode(False, deterministic=True):
        # Card against CPU: one step at batch 2 from the same weights.
        small = {k: (v if k == "info" else v[:2]) for k, v in batch.items()}
        card = FusionTrainer(cfg, attn, device=dev)
        cpu = FusionTrainer(cfg, attn, device="cpu")
        got, ref = card.train_step(small), cpu.train_step(small)
        loss_rel = max(abs(float(got[k]) - float(ref[k])) / max(abs(float(ref[k])), 1e-12)
                       for k in ref if k != "p")
        w_err = max((card.fuse_net.state_dict()[k].cpu() - v).abs().max().item()
                    for k, v in cpu.fuse_net.state_dict().items())
        rep["card_vs_cpu"] = {"loss_max_rel": loss_rel, "weight_max_abs": w_err}
        # Losses: fp32 convolutions in cuDNN's order against the CPU's;
        # weights: one Adam step moves each by ~lr = 1e-4, so 1% of it.
        check(loss_rel <= 1e-4 and w_err <= 1e-6, f"card vs CPU {rep['card_vs_cpu']}")
        del cpu
        # Checkpoint round trip: save, restore into a fresh trainer, one
        # step on both: equal weights.
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        mgr.save(trainer.it, trainer.state_dict())
        restored = FusionTrainer(cfg, attn, device=dev)
        restored.load_state_dict(mgr.restore())
        check(restored.it == trainer.it == TRAIN_STEPS + 1, "restored iteration")
        trainer.train_step(batch)
        restored.train_step(batch)
        check(all(torch.equal(v, restored.fuse_net.state_dict()[k])
                  for k, v in trainer.fuse_net.state_dict().items()),
              "a restored trainer's step differs from the saved one's")
    del restored, card
    # The step alone: the last batch again with no loader worker running
    # (the measured loop's steps share the host with 8 loader workers),
    # and one step under the profiler.
    with cudnn_mode(benchmark=True):
        alone = []
        for _ in range(6):
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            alone.append((time.perf_counter() - t0) * 1e3)
        rep["alone_step_ms"] = alone[1:]
        rep["alone_median_step_ms"] = float(np.median(alone[1:]))
        rep["step_profile"] = device_profile(lambda: trainer.train_step(batch))
    del trainer, loader

    # The loader alone, past the batches its workers queue at the start
    # (the measured loop drew most of its batches from that queue, filled
    # during the warm step): the rate it sustains.
    queued = 2 * 8   # DataLoader's prefetch_factor x workers
    fed = iter(Loader(dataset, TRAIN_BATCH, sampler=ShardedSampler(
        TRAIN_BATCH * (queued + LOADER_BATCHES), seed=cfg.seed),
        num_workers=8, pin_memory=True))
    for _ in range(queued):
        next(fed)
    t0 = time.perf_counter()
    for _ in range(LOADER_BATCHES):
        next(fed)
    rep["loader_batches_s"] = LOADER_BATCHES / (time.perf_counter() - t0)
    fed.close()
    # `python -m mivos_tpu_torch.train` as a user runs it: the measure
    # phase's synthetic_lifecycle (two runs, a kill and a resume).
    rep["wall_s"] = time.perf_counter() - t_phase
    log(json.dumps(rep))
    log(json.dumps({"metric": "fusion_train_step_b12_384", "window_s": window_s,
                    "steps_s": rep["steps_s"], "samples_s": rep["samples_s"],
                    "median_step_ms": med,
                    "median_device_ms": rep["median_device_ms"],
                    "median_wait_ms": rep["median_wait_ms"],
                    "alone_median_step_ms": rep["alone_median_step_ms"],
                    "loader_batches_s": rep["loader_batches_s"],
                    "alone_device_busy_ms": rep["step_profile"]["device_busy_ms"],
                    "peak_gib": rep["peak_gib"]}))


@contextlib.contextmanager
def step_clock(cls, rec):
    """Record every step of trainer class `cls` within the block: its
    host ms, the wait for its batch since the previous step ended (the
    batch workers' lag behind the loop), CUDA-event ms from its start to
    its end (upload, forward, backward, optimizer, the read-back), and its
    loss and IoU."""
    orig_step = cls.step
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    last = []

    def step(self, seed, batch=None):
        t0 = time.perf_counter()
        if last:
            rec["wait_ms"].append((t0 - last[-1]) * 1e3)
        start.record()
        loss, iou = orig_step(self, seed, batch)
        end.record()
        end.synchronize()
        last.append(time.perf_counter())
        rec["step_ms"].append((last[-1] - t0) * 1e3)
        rec["device_ms"].append(start.elapsed_time(end))
        rec["loss"].append(loss)
        rec["iou"].append(iou)
        return loss, iou

    own = "step" in vars(cls)
    cls.step = step
    try:
        yield
    finally:
        if own:
            cls.step = orig_step
        else:
            del cls.step


def new_record():
    return {k: [] for k in ("wait_ms", "step_ms", "device_ms", "loss", "iou")}


def curve_summary(rec, dev):
    """Median step, device and wait ms, peak GiB, and the mean loss and
    IoU of the first and the last PRE_WINDOW steps."""
    w = min(PRE_WINDOW, len(rec["loss"]))
    return {"steps": len(rec["loss"]),
            "median_step_ms": float(np.median(rec["step_ms"])),
            "median_device_ms": float(np.median(rec["device_ms"])),
            "median_wait_ms": float(np.median(rec["wait_ms"] or [0.0])),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "first_loss": float(np.mean(rec["loss"][:w])),
            "last_loss": float(np.mean(rec["loss"][-w:])),
            "first_iou": float(np.mean(rec["iou"][:w])),
            "last_iou": float(np.mean(rec["iou"][-w:]))}


def pretrain_card_vs_cpu(dev):
    """The same random-init weights in a PropPretrainer on the card and on
    the CPU at 48x48, 3 steps of chain_mix (1, 2): losses within 1e-4
    relative, every trained tensor within 3 * lr (the most Adam moves a
    tensor whose gradient is rounding noise)."""
    net = init_params(PropagationNetwork(top_k=TOP_K, read_backend="exact"),
                      torch.Generator().manual_seed(4))
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    trainers = {d: PropPretrainer(params=sd, hw=(48, 48), lr=PRE_LR,
                                  chain_mix=(1, 2), device=d) for d in (dev, "cpu")}
    losses = {d: [tr.step(s)[0] for s in range(3)] for d, tr in trainers.items()}
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses[dev], losses["cpu"]))
    cpu_sd = trainers["cpu"].state_dict()
    w_err = max((v.cpu() - cpu_sd[k]).abs().max().item()
                for k, v in trainers[dev].state_dict().items())
    rep = {"losses_card": losses[dev], "losses_cpu": losses["cpu"],
           "loss_max_rel": rel, "weight_max_abs": w_err, "lr": PRE_LR}
    check(rel <= 1e-4 and w_err <= 3 * PRE_LR, f"pretrain card vs CPU {rep}")
    return rep


def pretrain_stage(kind, argv, dev):
    """python -m mivos_tpu_torch.pretrain_synthetic --net `kind` in
    process under step_clock: every loss finite, the last PRE_WINDOW
    steps' mean loss below the first's."""
    rec = new_record()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with step_clock(pretrain_synthetic.TRAINERS[kind], rec):
        pretrain_synthetic.main(["--net", kind, "--device", str(dev),
                                 "--log-every", "100", *argv])
    rep = dict(curve_summary(rec, dev), wall_s=time.perf_counter() - t0)
    check(all(np.isfinite(rec["loss"])), f"{kind}: non-finite losses")
    check(rep["last_loss"] < rep["first_loss"], f"{kind}: no descent {rep}")
    return rep


def pretrain_chain3(out, dev):
    """Chain-3 steps at CHAIN3_HW from the prop stage's weights, a fresh
    Adam (as --resume), as many as CHAIN3_BOX_S allows, batches built
    ahead as the CLI builds them; saved and
    logged through the CLI's writer. Returns the curve summary and one
    step under the profiler for each of the two prop shapes."""
    ckpt = pretrain_synthetic.checkpoint_path(out, "prop")
    sd = read_state_dict(ckpt)
    profiles = {}
    for hw, chain in (((PRE_HW, PRE_HW), 1), (CHAIN3_HW, 3)):
        probe = PropPretrainer(params=sd, hw=hw, lr=CHAIN3_LR, chain_steps=chain,
                               device=dev)
        batch = probe.host_batch(CHAIN3_SEED)
        profiles[f"{hw[0]}x{hw[1]}_chain{chain}"] = device_profile(
            lambda: probe.step(CHAIN3_SEED, batch))
        del probe
    tr = PropPretrainer(params=sd, hw=CHAIN3_HW, lr=CHAIN3_LR, chain_steps=3,
                        device=dev)
    rec = new_record()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with step_clock(PropPretrainer, rec):
        feed = batches(tr, range(CHAIN3_SEED, CHAIN3_SEED + 10**5))
        for seed, batch in feed:
            tr.step(seed, batch)
            if time.perf_counter() - t0 >= CHAIN3_BOX_S:
                break
        del feed
    rep = dict(curve_summary(rec, dev), wall_s=time.perf_counter() - t0,
               profiles=profiles)
    check(all(np.isfinite(rec["loss"])), "chain 3: non-finite losses")
    save_params(ckpt, tr.net)
    log_path = os.path.join(out, "pretrain_log.json")
    with open(log_path) as f:
        old = json.load(f)
    pretrain_synthetic.merge_log(
        old, "prop", {"loss": rec["loss"], "iou": rec["iou"],
                      "step": list(range(len(rec["loss"])))},
        {"steps": len(rec["loss"]), "hw": list(CHAIN3_HW), "lr": CHAIN3_LR,
         "seed": CHAIN3_SEED, "resume": True, "chain": [3]}, resume=True)
    with open(log_path, "w") as f:
        json.dump(old, f)
    return rep


def held_out_session(dev, sd, hw):
    """One interaction on frame 0 of a held-out synthetic video
    (HELD_OUT_SEED, outside every training seed) of `hw` frames through
    InferenceCore, bf16, on the kernels: the mean IoU of frames 1..
    against the ground truth, the share of object probabilities with
    |p - 0.5| < 0.07, and the launch counts of its reads."""
    prop = PropagationNetwork(top_k=TOP_K, dtype=BF16)
    prop.load_state_dict(sd)
    fuse = init_params(FusionNet(dtype=BF16), torch.Generator().manual_seed(0))
    images, gt = synthetic_sequence(HELD_OUT_SEED, HELD_T, *hw, HELD_K)
    fg = labels_to_onehot(gt[0], HELD_K)
    mask = np.concatenate([1.0 - fg.sum(0, keepdims=True), fg])
    core = InferenceCore(prop, fuse, im_normalize(images), HELD_K,
                         mem=MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ), device=dev)
    reads = reads_of(core, 0)
    cmr.reset_launch_counts()
    labels = core.interact(mask, 0)
    torch.cuda.synchronize()
    counts = cmr.launch_counts()
    check(counts == {name: n * reads for name, n in cmr.launches_per_read(BF16, 0).items()},
          f"held-out session launches {counts} for {reads} reads")
    session_invariants(core, labels)
    ious = []
    for t in range(1, HELD_T):
        for k in range(1, HELD_K + 1):
            a, b = labels[t] == k, gt[t] == k
            ious.append((a & b).sum() / max((a | b).sum(), 1))
    lw, uw, lh, uh = core.pad
    probs = torch.stack([core.get_prob(t)[1:, 0, lh:core.nh - uh, lw:core.nw - uw]
                         for t in range(1, HELD_T)])
    near = ((probs - 0.5).abs() < 0.07).float().mean().item()
    return {"mean_iou": float(np.mean(ious)), "near_tie_share": near,
            "reads": reads}, counts


def pretrain_fusion(dev, tmp, prop_pth):
    """python -m mivos_tpu_torch.train_fusion_synthetic in process from the
    pretrained prop weights: FS_VIDEOS videos, FS_ITERS iterations at
    batch TRAIN_BATCH. Its generate_fusion reads launch the fp32 kernels;
    returns their counts (zeroed just before) and the phase's report."""
    root = os.path.join(tmp, "fusion_syn")
    argv = ["--root", root, "--weights", prop_pth,
            "--out", os.path.join(tmp, "weights", "fusion_synthetic.pth"),
            "--videos", str(FS_VIDEOS), "--frames", str(FS_FRAMES),
            "--hw", str(FS_HW), "--separation", str(FS_SEPARATION),
            "--iterations", str(FS_ITERS), "--batch", str(TRAIN_BATCH),
            "--report-every", str(FS_REPORT), "--num-workers", "8",
            "--device", str(dev)]
    split = {}
    cmr.reset_launch_counts()   # the generate_fusion run's launches start here
    with timed_calls(FusionGenerator, "interact_mask", split), \
            timed_calls(generate_fusion, "_save_png", split):
        summary = train_fusion_synthetic.main(argv)
    counts = cmr.launch_counts()
    dataset = DAVISTestDataset(os.path.join(root, "trainval"), imset="2017/train.txt")
    refs = [f for i in range(len(dataset)) for f in range(0, FS_FRAMES, FS_SEPARATION)
            if usable_objects(dataset[i]["gt"], f)]
    reads = len(refs) * (FS_FRAMES - 1)
    check(counts == {name: n * reads for name, n in cmr.launches_per_read(F32, 0).items()},
          f"train_fusion_synthetic's generate_fusion launches {counts} for {reads} reads")
    pngs = sum(len(fs) for _, _, fs in os.walk(os.path.join(root, "fusion")))
    rep = {"videos": FS_VIDEOS, "frames": FS_FRAMES, "hw": FS_HW,
           "separation": FS_SEPARATION, "reads": reads, "pngs": pngs,
           "generate_s": summary["generate_s"],
           "interact_mask_s": split["interact_mask"], "png_write_s": split["_save_png"],
           "png_share": split["_save_png"] / summary["generate_s"],
           "ms_per_png": split["_save_png"] / pngs * 1e3,
           "train_s": summary["train_s"], "iterations": summary["it"],
           "losses": summary["losses"], "p": summary["p"]}
    return counts, rep


def phase_pretrain(dev, tmp):
    """Synthetic pretraining (module docstring, phase 13). Returns the
    launch counts of its two kernel paths and each kernel's worst error
    in the gate on trained-like banks."""
    t_phase = time.perf_counter()
    rep = {"phase": "pretrain"}
    with cudnn_mode(False, deterministic=True):
        rep["card_vs_cpu"] = pretrain_card_vs_cpu(dev)
    log(json.dumps({"pretrain_card_vs_cpu": rep["card_vs_cpu"]}))
    out = os.path.join(tmp, "weights")
    common = ["--out", out, "--lr", str(PRE_LR), "--hw", str(PRE_HW),
              "--seed", str(PRE_SEED)]
    with cudnn_mode(benchmark=True):   # fixed shapes a stage
        for kind in ("prop", "s2m", "fbrs"):
            rep[kind] = pretrain_stage(kind, common + ["--steps", str(PRE_STEPS[kind])], dev)
            log(json.dumps({"pretrain": kind, **rep[kind]}))
            if kind == "prop":
                # The single-step snapshot curriculum_ab holds the chain-3
                # weights against.
                shutil.copyfile(pretrain_synthetic.checkpoint_path(out, "prop"),
                                os.path.join(out, S1_NAME))
                rep["prop_chain3"] = pretrain_chain3(out, dev)
                log(json.dumps({"pretrain": "prop_chain3", "hw": CHAIN3_HW,
                                **rep["prop_chain3"]}))
    prop_pth = pretrain_synthetic.checkpoint_path(out, "prop")
    prop_sd = read_state_dict(prop_pth)
    load_reference_pth(S2MNetwork(), pretrain_synthetic.checkpoint_path(out, "s2m"))
    build_fbrs_from_state_dict(read_state_dict(pretrain_synthetic.checkpoint_path(out, "fbrs")))
    with open(os.path.join(out, "pretrain_log.json")) as f:
        check(sorted(json.load(f)) == ["fbrs", "prop", "s2m"], "pretrain_log.json nets")

    random_sd = init_params(PropagationNetwork(), torch.Generator().manual_seed(0)).state_dict()
    with cudnn_mode(False, deterministic=True):
        # The main one at 480x854 (its launches are this path's), then at
        # the first stage's training size.
        for hw in ((RH, RW), (PRE_HW, PRE_HW)):
            key = "held_out" if hw == (RH, RW) else f"held_out_{hw[0]}"
            rep[key], counts = held_out_session(dev, prop_sd, hw)
            if hw == (RH, RW):
                session_counts = counts
            rep[key + "_random_init"], _ = held_out_session(dev, random_sd, hw)
            log(json.dumps({"held_out_session": [HELD_T, *hw, HELD_K],
                            "pretrained": rep[key],
                            "random_init": rep[key + "_random_init"]}))
    torch.cuda.empty_cache()
    errs = gate_session_shapes(*kc.encoder_banks(kc.prop_net(prop_pth), GATE_FRAMES, dev),
                               "pretrained", log)
    log(json.dumps({"pretrained_gate_per_kernel_max_abs_err": errs}))
    torch.cuda.empty_cache()
    with cudnn_mode(benchmark=True):
        fusion_counts, rep["fusion"] = pretrain_fusion(dev, tmp, prop_pth)
    log(json.dumps({"pretrain_fusion": rep["fusion"]}))
    rep["wall_s"] = time.perf_counter() - t_phase
    log(json.dumps({"phase": "pretrain", "wall_s": rep["wall_s"],
                    "stages_s": {k: rep[k]["wall_s"] for k in
                                 ("prop", "prop_chain3", "s2m", "fbrs")}}))
    return {"session": session_counts, "fusion_gen": fusion_counts}, errs


def phase_accuracy(dev, tmp):
    """The accuracy paths on the pretrain phase's weights: (1) python -m
    mivos_tpu_torch.accuracy_envelope in process on its prop .pth and
    fusion .pth (fast: bf16 and the kernels; exact: fp32, TF32 off, the
    exact read; 30 frames 480x854, K = 3, 2 rounds), its JAX gates, then
    envelope_diagnose on its dump; (2) python -m
    mivos_tpu_torch.full_protocol in process on its prop and S2M .pth,
    fusion off (2 sequences of 40 frames 480x854, K = 2, 8 rounds): the
    JAX timing gate held, J&F in [0, 1], the |dJ&F| bound's verdict
    reported. Launch counters, zeroed before each, equal each path's
    reads times the launches per read. Returns the envelope's and the
    protocol's counts."""
    out = os.path.join(tmp, "weights")
    fusion = os.path.join(out, "fusion_synthetic.pth")
    argv = ["--weights", pretrain_synthetic.checkpoint_path(out, "prop"),
            "--device", str(dev), "--dump-dir", tmp]
    if os.path.exists(fusion):
        argv += ["--fusion-weights", fusion]
    t0 = time.perf_counter()
    cmr.reset_launch_counts()   # the envelope's launches start here
    rep = accuracy_envelope.envelope(accuracy_envelope.parse_args(argv), log=log)
    env_counts = cmr.launch_counts()
    reads = 2 * accuracy_envelope.T - 3   # frames 1..T-1, then T-2..1
    check(env_counts == {name: n * reads for name, n in cmr.launches_per_read(BF16, 0).items()},
          f"envelope launches {env_counts} for {reads} reads")
    rep["wall_s"] = time.perf_counter() - t0
    log(json.dumps({"envelope": rep}))
    accuracy_envelope.check_gates(rep)
    envelope_diagnose.main([rep["dump"], "--out", os.path.join(tmp, "envelope_diagnosis.json")])

    t0 = time.perf_counter()
    reads = {}
    with counted_reads(reads):
        cmr.reset_launch_counts()   # the protocol's launches start here
        prep = full_protocol.protocol(full_protocol.parse_args(
            ["--weights", out, "--fusion", "off", "--device", str(dev),
             "--out", os.path.join(tmp, "full_protocol.json")]), log=log)
        counts = cmr.launch_counts()
    check(sorted(reads) == ["auto", "exact"] and reads["auto"] > 0,
          f"full protocol reads {reads}")
    check(counts == {c: n * reads["auto"] for c, n in cmr.launches_per_read(BF16, 0).items()},
          f"full protocol launches {counts} for {reads['auto']} reads")
    log(json.dumps({"full_protocol": {
        "fusion": prep["fusion"], "max_round_jf_delta": prep["max_round_jf_delta"],
        "within_jax_bound": prep["max_round_jf_delta"] < full_protocol.JF_DELTA_MAX,
        "per_round_jf_delta": prep["per_round_jf_delta"],
        "auc": {t: prep[t]["summary"]["auc"] for t in ("fast", "exact")},
        "per_round_s": {t: prep[t]["per_round_s"] for t in ("fast", "exact")},
        "records": {t: prep[t]["summary"]["records"] for t in ("fast", "exact")},
        "reads": reads, "wall_s": time.perf_counter() - t0}}))
    full_protocol.check_timing(prep)
    check(all(0.0 <= jf <= 1.0 for t in ("fast", "exact")
              for recs in prep[t]["summary"]["records"].values() for _, jf in recs),
          "full protocol: J&F outside [0, 1]")
    # The |dJ&F| bound is reported, not held: on weights of this recipe
    # (J&F 0.1-0.3) JAX's own fast path crosses it as well (PERF.md).
    return env_counts, counts


def phase_measure(dev, tmp):
    """The measuring entry points' mains at full width, the pretrain
    phase's weights where they take weights (module docstring, phase
    13c). Each holds its own kernel launches to its reads; returns them
    by path."""
    out = os.path.join(tmp, "weights")
    prop, fbrs = (pretrain_synthetic.checkpoint_path(out, net) for net in ("prop", "fbrs"))
    res = os.path.join(tmp, "measure")
    os.makedirs(res, exist_ok=True)
    seconds = {}

    def run(name, fn, *argv):
        t0 = time.perf_counter()
        rep = fn([*argv, "--device", str(dev)])
        seconds[name] = time.perf_counter() - t0
        log(f"measure {name}: {seconds[name]:.1f} s")
        return rep

    with cudnn_mode(benchmark=True):   # the bench protocol's setting
        headline = run("bench", bench.main)
        slim = run("slim_decoder_bench", slim_decoder_bench.main)
    check(headline["kernel_gate"]["ok"], f"bench gate {headline['kernel_gate']}")
    kernel = run("kernel_check", kc.main, "--weights", prop,
                 "--out", os.path.join(res, "kernel_check.json"))
    sweep = run("refine_sweep", refine_sweep.main, "--weights", prop,
                "--out", os.path.join(res, "refine_sweep.json"))
    for row, counts in zip(sweep["rows"], sweep["launches"]):
        check(counts["refine_bf16"] == counts["refine_merge"]
              == row["n_refine"] * counts["candidates_bf16"],
              f"refine_sweep n_refine={row['n_refine']}: launches {counts}")
    run("mfu_report", mfu_report.main, "--measure", "8", "--fps", str(headline["value"]),
        "--out", os.path.join(res, "mfu_report.json"))
    run("interactive_latency_bench", interactive_latency_bench.main)
    stream = run("serve_streaming_bench", serve_streaming_bench.main)
    check(not stream["qcache_enabled"], "300 frames of 480x854 should exceed the query "
          "cache's byte cap")
    run("train_step_bench", train_step_bench.main)
    # noc_synthetic's evaluation and report on the 200-step weights. Its
    # asserts (the IoU climbs with the clicks, ends >= 0.80) are not held
    # here: on weights of this recipe the second click drops the IoU in
    # both packages (scripts/torch_noc_witness.py, PERF.md).
    t0 = time.perf_counter()
    noc = noc_synthetic.evaluate(load_reference_pth(noc_synthetic.make_net(), fbrs),
                                 (PRE_HW, PRE_HW), NOC_SCENES, "f-BRS-B", 20, 20, dev)
    seconds["noc_synthetic"] = time.perf_counter() - t0
    log(json.dumps({"noc_synthetic": {k: v for k, v in noc.items() if k != "trajectories"},
                    "first_clicks": [t[0] for t in noc["trajectories"]],
                    "clicks": [len(t) for t in noc["trajectories"]]}))
    curriculum = run("curriculum_ab", curriculum_ab.main, "--chain-weights", prop,
                     "--s1-weights", os.path.join(out, S1_NAME),
                     "--out", os.path.join(res, "curriculum_ab.json"))
    life = run("synthetic_lifecycle", synthetic_lifecycle.main, "--weights", prop,
               "--root", os.path.join(tmp, "lifecycle"), "--iterations", str(LIFE_ITERS),
               "--batch", str(LIFE_BATCH), "--save-every", str(LIFE_SAVE),
               "--report-every", str(LIFE_REPORT),
               "--out", os.path.join(res, "synthetic_training_run.md"))
    log(json.dumps({"phase": "measure", "seconds": seconds}))
    return {"bench": headline["launches"], "kernel_check": kernel["launches"],
            "refine_sweep": {name: sum(c[name] for c in sweep["launches"])
                             for name in sweep["launches"][0]},
            "slim_ab": slim["launches"], "serve_stream": stream["launches"],
            "curriculum": curriculum["launches"], "lifecycle": life["launches"]}


@contextlib.contextmanager
def counted_reads(reads):
    """Wrap InferenceCore.interact for the duration: add the memory reads
    each call makes to reads[its net's read backend]."""
    orig = InferenceCore.interact

    def interact(self, mask, idx):
        backend = self.prop_net.read_backend
        reads[backend] = reads.get(backend, 0) + reads_of(self, idx)
        return orig(self, mask, idx)

    InferenceCore.interact = interact
    try:
        yield
    finally:
        InferenceCore.interact = orig


# ----------------------------------------------------------------------
# multichip: sharded reads and sessions on a device mesh, data-parallel
# training over ranks, the dry run.
# ----------------------------------------------------------------------

MC_SHARDS = (2, 4)                  # position shards of the sharded read
MC_OBJECT, MC_2D = 3, (3, 2)        # object axis; object x data
MC_BANK_D = 4                       # position shards of the bank-sharded session
# max |dp| on frames 1-5, fp32, TF32 off: the reads agree to rounding
# (1e-7 of the readout scale), but a top-k near-tie that one read
# resolves otherwise moves a pixel by up to ~1e-3.
MC_PROB_TOL = 2e-3
MC_MARGIN, MC_AGREE = 0.07, 1 - 4e-4   # decided pixels; the envelope's flips
MC_DDP_BATCH, MC_DDP_HW, MC_DDP_STEPS = 12, 384, 2
MC_BN_SHAPE = (12, 64, 48, 48)      # N, C, H, W of the SyncBatchNorm check
MC_BN_TOL = 1e-4                    # fp32 sums in another order, values ~1
MC_DRYRUN = 4
MC_PROFILE_T = 6                    # frames of the profiled clip


def mc_devices(n):
    """n mesh positions: n distinct cards when the host has them, else
    cuda:0 repeated n times (one card)."""
    count = torch.cuda.device_count()
    if count >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def mc_layout(mesh):
    devs = [str(d) for d in mesh.devices.reshape(-1)]
    return {"axes": mesh.shape, "devices": devs,
            "repeated": len(set(devs)) < len(devs)}


def mc_read(dev, banks):
    """The bank-sharded exact read on the gate's banks (K = 3, N = 1620,
    M = 21060 and 42120, the last TAIL slots invalid, fp32 and bf16) over
    MC_SHARDS position shards and the 2D layout (MC_2D object x data),
    and the object-sharded read over MC_OBJECT object shards (the read
    kernels on each), against the unsharded exact torch.topk read: mean
    error < 1e-3 and max < 0.3 of the readout scale (the kernel gate's
    bounds). The object-sharded and 2D reads run as the sessions run
    them, each object shard's readout left on its device (gather=False).
    CUDA-event ms of each beside the exact read and the kernel read."""
    mk_all, mv_all, q = banks
    layouts = {f"data{d}": (make_mesh(d, devices=mc_devices(d)), "data", None)
               for d in MC_SHARDS}
    layouts[f"object{MC_OBJECT}"] = (make_mesh(MC_OBJECT, axis="object",
                                               devices=mc_devices(MC_OBJECT)),
                                     None, "object")
    layouts["object3xdata2"] = (make_mesh_nd(object=MC_2D[0], data=MC_2D[1],
                                             devices=mc_devices(int(np.prod(MC_2D)))),
                                "data", "object")

    def read(mesh, axis, obj, grids, valid):
        if axis is None:
            return object_sharded_memory_read(mesh, *grids, q, TOP_K, valid, obj,
                                              gather=False)
        return sharded_memory_read(mesh, *grids, q, TOP_K, valid, axis, obj,
                                   gather=obj is None)

    log(json.dumps({"multichip_meshes": {n: mc_layout(m) for n, (m, _, _) in layouts.items()}}))
    m_all = mk_all.shape[1]
    for m in (m_all // 2, m_all):
        valid = torch.arange(m, device=dev) < m - TAIL
        for dtype in (F32, BF16):
            mk = mk_all[:, :m].to(dtype).contiguous()
            mv = mv_all[:, :m].to(dtype).contiguous()
            exact_fn = lambda: memory_read(mk, mv, q, top_k=TOP_K, valid=valid,  # noqa: E731
                                           backend="exact")
            exact = exact_fn()
            scale = exact.abs().mean().item()
            rep = {"K": mk.shape[0], "N": q.shape[0], "M": m, "dtype": str(dtype)[6:],
                   "readout_scale": scale, "exact_ms": cuda_ms(exact_fn, 3, 1),
                   "kernel_ms": cuda_ms(lambda: cmr.memory_read_threshold_cuda(
                       mk, mv, q, TOP_K, valid)), "sharded": {}}
            for name, (mesh, axis, obj) in layouts.items():
                grids = shard_bank(mesh, mk, mv, axis, obj)
                fn = lambda: read(mesh, axis, obj, grids, valid)  # noqa: E731
                out = fn()
                out = out if obj is None else torch.cat([r.to(dev) for r in out])
                err = (out - exact).abs()
                r = {"vs_exact_mean": err.mean().item(), "vs_exact_max": err.max().item(),
                     "ms": cuda_ms(fn, 3, 1)}
                rep["sharded"][name] = r
                check(r["vs_exact_mean"] < 1e-3 * scale and r["vs_exact_max"] < 0.3 * scale,
                      f"sharded read {name} vs exact {rep}")
                del grids
            log(json.dumps({"multichip_read": rep}))
            del mk, mv, exact


def mc_modes():
    """mode -> (mesh, MemoryConfig sharding fields, the unsharded
    session's read backend it is held to)."""
    return {
        "bank": (make_mesh(MC_BANK_D, devices=mc_devices(MC_BANK_D)),
                 dict(bank_sharded=True), "exact"),
        "object": (make_mesh(MC_OBJECT, axis="object", devices=mc_devices(MC_OBJECT)),
                   dict(object_sharded=True), "auto"),
        "2d": (make_mesh_nd(object=MC_2D[0], data=MC_2D[1],
                            devices=mc_devices(int(np.prod(MC_2D)))),
               dict(object_sharded=True, bank_sharded=True), "exact")}


def label_mask(lab):
    """(K+1, H, W, 1) hard probabilities of a label map."""
    fg = (lab[None] == np.arange(1, K + 1)[:, None, None]).astype(np.float32)
    return np.concatenate([1.0 - fg.sum(0, keepdims=True), fg])[..., None]


def mc_rounds(core, masks):
    """The session's first round (frame 0) and fusion round (frame T-1)
    under `masks`, as many as it holds: per round the (T, K+1, nh, nw)
    probabilities and the seconds."""
    out = []
    for idx, mask in zip((0, T - 1), masks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = core.interact(mask, idx)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        session_invariants(core, labels)
        out.append((torch.stack([core.get_prob(t)[:, 0] for t in range(T)]), dt))
    return out


def mc_sessions(dev):
    """Each sharded mode's two rounds on fp32 nets (TF32 off) against the
    unsharded session on the same read backend: max |dp| on frames 1-5
    <= MC_PROB_TOL, and labels equal on >= MC_AGREE of the pixels the
    unsharded session decides by > MC_MARGIN, every frame, both rounds.
    Then bf16 rounds per mode (frames/s of a first and a fusion round
    and of a second session's first round; a warm session first) with the
    read kernels' launches, zeroed just before each mode and read just
    after: the object-sharded reads launch each kernel once a read on
    each object shard; bank and 2D reads are the exact sharded read and
    launch none. Then the CUDA kernels a frame of the unsharded and the
    object-sharded bf16 sessions launch (profiler, a MC_PROFILE_T-frame
    clip). Returns (fp32 object launches, bf16 launches by mode)."""
    t0 = time.perf_counter()
    frames, labels = synthetic_video(31, T, RH, RW, K)
    frames = torch.from_numpy(frames).to(dev)
    masks = [label_mask(labels[0]), label_mask(labels[T - 1])]
    modes = mc_modes()
    prop32, fuse = make_nets(dev, F32)
    nets = {}
    for backend in ("exact", "auto"):    # shallow copies share the weights
        nets[backend] = copy.copy(prop32)
        nets[backend].read_backend = backend
    refs = {backend: mc_rounds(InferenceCore(prop, fuse, frames, K, mem=MemoryConfig(
        top_k=TOP_K, mem_freq=MEM_FREQ), device=dev), masks)
        for backend, prop in nets.items()}
    fp32_object_launches = None
    for mode, (mesh, sharding, backend) in modes.items():
        prop = nets[backend]
        mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ, **sharding)
        cmr.reset_launch_counts()
        got = mc_rounds(InferenceCore(prop, fuse, frames, K, mem=mem, mesh=mesh,
                                      device=dev), masks)
        counts = cmr.launch_counts()
        if mode == "object":   # each object shard reads 59 + 58 frames
            fp32_object_launches = counts
            for name, n in cmr.launches_per_read(F32, 0).items():
                want = n * (2 * T - 3) * MC_OBJECT
                check(counts[name] == want,
                      f"fp32 object: {name} launched {counts[name]} times, want {want}")
        rep = {"mode": mode, "mesh": mc_layout(mesh), "dtype": "float32",
               "held_to": f"unsharded, read {backend}", "rounds": []}
        for (ref, ref_s), (p, s) in zip(refs[backend], got):
            top2 = ref.topk(2, dim=1).values
            decided = (top2[:, 0] - top2[:, 1]) > MC_MARGIN
            agree = (ref.argmax(1) == p.argmax(1))[decided].float().mean().item()
            rep["rounds"].append({
                "max_dp_frames_1_5": (ref[1:6] - p[1:6]).abs().max().item(),
                "max_dp_all": (ref - p).abs().max().item(),
                "mean_dp_all": (ref - p).abs().mean().item(),
                "decided_share": decided.float().mean().item(),
                "decided_agreement": agree, "round_s": s, "unsharded_round_s": ref_s})
        log(json.dumps({"multichip_session": rep}))
        for r in rep["rounds"]:
            check(r["max_dp_frames_1_5"] <= MC_PROB_TOL and r["decided_agreement"] >= MC_AGREE,
                  f"{mode} session vs unsharded {rep}")
    del refs
    log(f"multichip fp32 sessions: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    prop, fuse = make_nets(dev, BF16)
    bf16, launches = {}, {}
    for mode, (mesh, sharding, _) in {"unsharded": (None, {}, "auto"), **modes}.items():
        mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ, **sharding)
        new = lambda: InferenceCore(prop, fuse, frames, K, mem=mem, mesh=mesh,  # noqa: E731
                                    device=dev)
        new().interact(masks[0], 0)                 # warm
        cmr.reset_launch_counts()
        (_, first_s), (_, fusion_s) = mc_rounds(new(), masks)
        (_, again_s), = mc_rounds(new(), masks[:1])
        launches[mode] = cmr.launch_counts()
        reads = 3 * (T - 1) - 1                     # 59 + 58 + 59 frames propagated
        per_read = cmr.launches_per_read(BF16, 0)
        shards = MC_OBJECT if mode == "object" else 1
        want = 0 if sharding.get("bank_sharded") else reads * shards
        for name, n in per_read.items():
            check(launches[mode][name] == n * want,
                  f"{mode}: {name} launched {launches[mode][name]} times, want {n * want}")
        bf16[mode] = {"first_round_frames_s": [(T - 1) / first_s, (T - 1) / again_s],
                      "fusion_round_frames_s": (T - 2) / fusion_s,
                      "read_kernel_launches": sum(launches[mode].values()),
                      "read_kernel_launches_per_frame": sum(launches[mode].values()) / reads}
    for mode in ("unsharded", "object"):   # a short clip: the profiler's events add up
        mesh, sharding = (None, {}) if mode == "unsharded" else modes[mode][:2]
        mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ, **sharding)
        core = InferenceCore(prop, fuse, frames[:MC_PROFILE_T], K, mem=mem, mesh=mesh,
                             device=dev)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            core.interact(masks[0], 0)
            torch.cuda.synchronize()
        kernels = sum(a.count for a in prof.key_averages()
                      if a.device_type == torch.autograd.DeviceType.CUDA)
        bf16[mode]["cuda_kernels_per_frame"] = kernels / (MC_PROFILE_T - 1)
    log(json.dumps({"multichip_session_bf16": bf16}))
    log(f"multichip bf16 sessions: {time.perf_counter() - t0:.1f} s")
    return fp32_object_launches, launches


def mc_ddp(dev):
    """Data-parallel FusionTrainer steps (MC_DDP_STEPS at batch
    MC_DDP_BATCH, MC_DDP_HW^2, fp32, TF32 off, deterministic cuDNN plans)
    and SyncBatchNorm over the ranks, against one process on the whole
    batch. World: min(4, cards) ranks over NCCL on two or more cards,
    else 2 ranks on cuda:0 over gloo. Weights: Adam moves an entry at
    most ~lr a step, and a gradient entry within rounding of zero may
    flip its step, so max |dw| <= 2 lr * steps; every other entry must
    agree: the 99.9th percentile of |dw| <= 1e-2 lr (without the ranks'
    gradient mean the half-batch steps part by ~lr on most entries)."""
    count = torch.cuda.device_count()
    world, backend = ((min(4, count), "nccl") if count >= 2 else (2, "gloo"))
    devs = [f"cuda:{i if count >= 2 else 0}" for i in range(world)]
    rng = np.random.RandomState(9)
    bn_x = (rng.randn(*MC_BN_SHAPE) * 2.0 + 0.5).astype(np.float32)
    bn_g = rng.randn(*MC_BN_SHAPE).astype(np.float32)
    attn = attention_read_state_dict(init_params(AttentionReadNetwork(),
                                                 torch.Generator().manual_seed(4)))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(train_rank, world, (devs, attn, MC_DDP_BATCH, MC_DDP_HW,
                                          MC_DDP_STEPS, bn_x, bn_g),
                      backend=backend, timeout_s=600)
    spawn_s = time.perf_counter() - t0

    with cudnn_mode(benchmark=False, deterministic=True):
        bn = SyncBatchNorm(MC_BN_SHAPE[1]).to(dev)
        x = torch.from_numpy(bn_x).to(dev).requires_grad_(True)
        bn(x)
        y = bn(x)
        (y * torch.from_numpy(bn_g).to(dev)).sum().backward()
        bn_err = {
            "y": float(np.abs(np.concatenate([r["bn_y"] for r in ranks])
                              - y.detach().cpu().numpy()).max()),
            "dx": float(np.abs(np.concatenate([r["bn_dx"] for r in ranks])
                               - x.grad.cpu().numpy()).max()),
            "dweight": float(np.abs(sum(r["bn_dweight"] for r in ranks)
                                    - bn.weight.grad.cpu().numpy()).max()
                             / np.abs(bn.weight.grad.cpu().numpy()).max()),
            "dbias": float(np.abs(sum(r["bn_dbias"] for r in ranks)
                                  - bn.bias.grad.cpu().numpy()).max()
                           / np.abs(bn.bias.grad.cpu().numpy()).max()),
            "running": max(float(np.abs(r["bn_running"][i] - t.cpu().numpy()).max())
                           for r in ranks for i, t in enumerate(
                               (bn.running_mean, bn.running_var)))}
        trainer = FusionTrainer(TrainConfig(iterations=100, steps=(80,),
                                            batch_size=MC_DDP_BATCH), attn, device=dev)
        init = {k: v.clone() for k, v in trainer.fuse_net.state_dict().items()}
        one_ms, one_loss = [], []
        for s in range(MC_DDP_STEPS):
            b = fusion_batch(MC_DDP_BATCH, MC_DDP_HW, MC_DDP_HW, s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_loss.append(float(trainer.train_step(b)["total_loss"]))
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3)
    lr = trainer.cfg.lr
    diffs = np.concatenate([np.abs(ranks[0]["weights"][k] - v.cpu().numpy()).ravel()
                            for k, v in trainer.fuse_net.state_dict().items()])
    moved = max(float((v - init[k]).abs().max()) for k, v in trainer.fuse_net.state_dict().items())
    rep = {"world": world, "backend": backend, "devices": devs, "spawn_s": spawn_s,
           "models": sorted({r["model"] for r in ranks}),
           "rank_step_ms": [r["step_ms"] for r in ranks], "one_process_step_ms": one_ms,
           "rank_losses": [r["loss"] for r in ranks], "one_process_losses": one_loss,
           "weights_max_abs_diff": float(diffs.max()),
           "weights_p999_abs_diff": float(np.quantile(diffs, 0.999)),
           "weights_moved": moved, "lr": lr,
           "ranks_agree": all(np.array_equal(ranks[0]["weights"][k], r["weights"][k])
                              for r in ranks for k in r["weights"]),
           "syncbn_err": bn_err}
    log(json.dumps({"multichip_ddp": rep}))
    check(rep["models"] == ["DistributedDataParallel"], f"ranks not under DDP {rep}")
    check(rep["ranks_agree"], "the ranks' weights differ")
    check(moved >= lr, f"the steps did not move the weights {rep}")
    check(rep["weights_max_abs_diff"] <= 2 * lr * MC_DDP_STEPS
          and rep["weights_p999_abs_diff"] <= 1e-2 * lr, f"DDP vs one process {rep}")
    check(max(bn_err.values()) <= MC_BN_TOL, f"SyncBatchNorm vs one process {bn_err}")
    return rep


def phase_multichip(dev, banks):
    """Returns (fp32 object-session launches, bf16 launches by mode)."""
    count = torch.cuda.device_count()
    log(json.dumps({"multichip_host": {
        "cards": count, "meshes": "distinct cards where a mesh has no more "
                                  "positions than cards, else cuda:0 repeated"}}))
    t0 = time.perf_counter()
    mc_read(dev, banks)
    torch.cuda.empty_cache()
    log(f"multichip read: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with cudnn_mode(benchmark=False, deterministic=True):
        launches = mc_sessions(dev)
    torch.cuda.empty_cache()
    log(f"multichip sessions: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mc_ddp(dev)
    torch.cuda.empty_cache()
    log(f"multichip ddp: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dryrun_multichip(MC_DRYRUN, mc_devices(MC_DRYRUN))
    log(f"multichip dryrun: {time.perf_counter() - t0:.1f} s")
    return launches


def main():
    card = phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    errs, timing, banks = phase_gate(dev)
    log(f"gate phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    phase_check(dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with cudnn_mode(benchmark=True):   # the bench protocol's setting
        launches_bf16, launches_f32 = phase_session(dev)
    log(f"session phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    long_launches, long_errs, long_timing_by_dtype, long_m = phase_long_video(dev)
    log(f"long_video phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_s2m(dev)
    log(f"s2m phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    davis_launches, davis_shapes = phase_davis(dev)
    torch.cuda.empty_cache()
    davis_errs = phase_gate_davis(banks, davis_shapes)
    torch.cuda.empty_cache()
    phase_davis_check(dev)
    log(f"davis phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_fbrs(dev)
    log(f"fbrs phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with cudnn_mode(benchmark=False, deterministic=True):
        phase_fbrs_modes(dev)
    log(f"fbrs_modes phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    with cudnn_mode(benchmark=False, deterministic=True):   # as in davis
        t0 = time.perf_counter()
        serve_launches = phase_serve(dev)
        log(f"serve phase: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gui_launches = phase_gui(dev)
        log(f"gui phase: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            fusion_gen_launches, fusion_gen_shapes, *data = phase_fusion_gen(dev, tmp)
            torch.cuda.empty_cache()
            fusion_gen_errs = phase_gate_davis(banks, fusion_gen_shapes, "fusion_gen")
            log(f"fusion_gen phase: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            phase_train(dev, tmp, *data)
            log(f"train phase: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            pretrain_launches, pretrain_errs = phase_pretrain(dev, tmp)
            log(f"pretrain phase: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            with cudnn_mode(benchmark=False, deterministic=True):
                envelope_launches, protocol_launches = phase_accuracy(dev, tmp)
            log(f"accuracy phase: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            measure_launches = phase_measure(dev, tmp)
            log(f"measure phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mc_object_fp32, mc_launches = phase_multichip(dev, banks)
    del banks
    log(f"multichip phase: {time.perf_counter() - t0:.1f} s")
    kernels = []
    for name, phase, dtype, counters in KERNELS:
        paths = ({"session": launches_bf16, "davis": davis_launches,
                  "serve": serve_launches, "gui": gui_launches,
                  "fusion_gen": fusion_gen_launches,
                  "pretrain_session": pretrain_launches["session"],
                  "object_session": mc_launches["object"],
                  "session_2d": mc_launches["2d"], "long_video": long_launches,
                  "envelope": envelope_launches, "full_protocol": protocol_launches,
                  **{path: measure_launches[path] for path in
                     ("bench", "kernel_check", "refine_sweep", "slim_ab", "serve_stream",
                      "curriculum")}} if dtype == BF16
                 else {"session_fp32": launches_f32,
                       "pretrain_fusion_gen": pretrain_launches["fusion_gen"],
                       "object_session_fp32": mc_object_fp32,
                       "kernel_check_fp32": measure_launches["kernel_check"],
                       "lifecycle": measure_launches["lifecycle"]})
        by_path = {path: sum(counts[c] for c in counters) for path, counts in paths.items()}
        session = paths["session" if dtype == BF16 else "session_fp32"]
        for c in counters:   # the session paths run every kernel (davis: no refine)
            check(session[c] > 0, f"{c} never launched on the session path")
        at = timing[dtype][TIMING_M[-1]]
        long_at = long_timing_by_dtype[dtype]
        kernels.append({
            "name": name, "route": "cuda", "source": SRC,
            "replaces": REPLACES[phase], "bank": str(dtype)[6:],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(e[str(dtype)[6:]][phase]
                               for e in (errs, davis_errs, fusion_gen_errs,
                                         pretrain_errs, long_errs)),
            "ms": at["kernel_ms"][phase], "plain_ms": at["plain_ms"][phase],
            "bound_ms": at["bound_ms"][phase], "bound_by": at["bound_by"][phase],
            "library_ms": None,   # no PyTorch call computes a thresholded top-k read
            "ms_by_M": {m: timing[dtype][m]["kernel_ms"][phase] for m in TIMING_M},
            "bound_ms_by_M": {m: timing[dtype][m]["bound_ms"][phase] for m in TIMING_M},
            "long_M": {"K": LONG_K, "M": long_m, "ms": long_at["kernel_ms"][phase],
                       "bound_ms": long_at["bound_ms"][phase],
                       "bound_by": long_at["bound_by"][phase]}})
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()  # any failure raises: non-zero exit, no result line
