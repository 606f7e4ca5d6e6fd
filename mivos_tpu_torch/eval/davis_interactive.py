"""DAVIS interactive-bot evaluation loop (counterpart of
mivos_tpu/eval/davis_interactive.py; reference eval_interactive_davis.py).

The official `davisinteractive` bot, or the in-repo robot
(eval/robot.py), simulates a user for up to 8 scribble rounds per
sequence; the summary holds AUC-J&F and J&F@60s. The import of
`davisinteractive` is deferred, so the rest of the port works without
it. Every session runs on one `device`, or over a `mesh` (a sharded
session, MemoryConfig.bank_sharded/object_sharded); there is no fallback
to another. `run_local_interactive_fleet` runs one whole session per
sequence per device instead.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from os import path
from typing import Dict, Optional

import numpy as np
import torch

from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.davis_processor import DAVISProcessor
from mivos_tpu_torch.core.inference import prepared_copies, session_device
from mivos_tpu_torch.data.video_datasets import DAVISTestDataset
from mivos_tpu_torch.eval.robot import LocalInteractiveSession
from mivos_tpu_torch.interactive.scribbles import is_empty
from mivos_tpu_torch.parallel.mesh import Mesh
from mivos_tpu_torch.utils.palette import save_indexed_png


def _adapt_sharding(mem: MemoryConfig, mesh: Optional[Mesh], k: int):
    """Per-sequence sharding downgrade: object counts vary across DAVIS
    sequences, and object sharding needs K divisible by the object axis.
    A sequence that does not divide runs object-unsharded; bank
    sharding, if asked for, keeps a position-only mesh over the same
    devices. Returns (mem, mesh) for the sequence."""
    if not mem.object_sharded or mesh is None or \
            k % mesh.shape[mem.object_axis] == 0:
        return mem, mesh
    mem2 = dataclasses.replace(mem, object_sharded=False)
    if not mem.bank_sharded:
        return mem2, None
    return mem2, Mesh(mesh.devices.reshape(-1), (mem.bank_axis,))


def run_davis_interactive(prop_net, fuse_net, s2m_net, davis_root: str,
                          out_path: str,
                          max_nb_interactions: int = 8,
                          max_time_per_interaction: int = 30,
                          save_mask: bool = False,
                          mem: MemoryConfig = MemoryConfig(),
                          subset: str = "trainval",
                          imset: str = "2017/val.txt",
                          device: torch.device | str = "cuda",
                          mesh: Optional[Mesh] = None) -> Dict:
    """Runs the official DavisInteractiveSession and returns its global
    summary (AUC-J&F, J&F@60s; reference eval_interactive_davis.py:74-108).
    subset/imset select the DAVIS split and must match the session's.
    mesh: sharded sessions (`_adapt_sharding` per sequence), whose
    first device `device` must be."""
    from davisinteractive.session.session import DavisInteractiveSession

    device = session_device(device, mesh)

    os.makedirs(out_path, exist_ok=True)
    trainval = path.join(davis_root, subset)
    dataset = DAVISTestDataset(trainval, imset=imset)
    images: Dict[str, np.ndarray] = {}
    num_objects: Dict[str, int] = {}
    for i in range(len(dataset)):
        d = dataset[i]
        name = d["info"]["name"]
        images[name] = d["rgb"]
        num_objects[name] = len(d["info"]["labels"])
    print(f"Finished loading {len(images)} sequences.")

    processor: Optional[DAVISProcessor] = None
    pred_masks = None
    last_seq = None
    user_iter = 0

    with DavisInteractiveSession(
            davis_root=trainval, report_save_dir=out_path,
            max_nb_interactions=max_nb_interactions,
            max_time=max_nb_interactions * max_time_per_interaction) as sess:
        while sess.next():
            sequence, scribbles, new_seq = sess.get_scribbles(only_last=True)
            if new_seq:
                # Per-sequence state is dropped here, as in the reference
                # (eval_interactive_davis.py:79-84).
                del processor
                seq_mem, seq_mesh = _adapt_sharding(mem, mesh,
                                                    num_objects[sequence])
                processor = DAVISProcessor(
                    prop_net, fuse_net, s2m_net, images[sequence],
                    num_objects[sequence], mem=seq_mem, device=device,
                    mesh=seq_mesh)
                print(sequence)
                if save_mask and pred_masks is not None:
                    _save_masks(out_path, user_iter, last_seq, pred_masks)
                if last_seq is None or sequence != last_seq:
                    last_seq, user_iter = sequence, 0
                else:
                    user_iter += 1

            pred_masks, next_masks, _ = processor.interact(scribbles)
            sess.submit_masks(pred_masks, next_masks)

        if save_mask and pred_masks is not None:
            _save_masks(out_path, user_iter, last_seq, pred_masks)
        summary = sess.get_global_summary(
            save_file=path.join(out_path, "summary.json"))
    return summary


def run_local_interactive(prop_net, fuse_net, s2m_net, sequences: Dict,
                          max_nb_interactions: int = 8,
                          max_time_per_interaction: int = 30,
                          mem: MemoryConfig = MemoryConfig(),
                          out_path: Optional[str] = None,
                          save_mask: bool = False,
                          device: torch.device | str = "cuda",
                          mesh: Optional[Mesh] = None,
                          write_summary: bool = True) -> Dict:
    """The in-repo robot and session (eval/robot.py) in place of the
    `davisinteractive` package: the full scribble -> S2M -> propagate ->
    fuse protocol on in-memory sequences.

    sequences: name -> (images (T,H,W,3) float, or a zero-arg callable
    returning them, gt (T,H,W) int labels, num_objects). Returns the
    global summary (auc, metric_at_60s, curve), `records`: the raw
    per-sequence (cumulative seconds, J&F) trajectories, and `rounds`:
    one dict per round with the interacted frame, whether it
    propagated or was skipped (empty scribbles), and the host seconds
    of the robot, of `DAVISProcessor.interact` and of the metrics. With
    out_path the summary is also written to <out_path>/summary.json
    (unless write_summary is False), and save_mask writes every round's
    masks to <out_path>/<round>/<sequence>/%05d.png. device and mesh:
    as run_davis_interactive's."""
    device = session_device(device, mesh)
    if out_path:
        os.makedirs(out_path, exist_ok=True)
    sess = LocalInteractiveSession(
        {n: (gt, k) for n, (_im, gt, k) in sequences.items()},
        max_nb_interactions=max_nb_interactions,
        max_time=max_nb_interactions * max_time_per_interaction,
        device=device)
    processor: Optional[DAVISProcessor] = None
    rounds = []
    with sess:
        while sess.next():
            t0 = time.perf_counter()
            name, scribbles, new_seq = sess.get_scribbles(only_last=True)
            rec = {"sequence": name, "round": len(sess.records[name]),
                   "robot_s": time.perf_counter() - t0}
            if new_seq:
                im, _gt, k = sequences[name]
                if callable(im):
                    im = im()
                del processor
                seq_mem, seq_mesh = _adapt_sharding(mem, mesh, k)
                processor = DAVISProcessor(prop_net, fuse_net, s2m_net, im, k,
                                           mem=seq_mem, device=device,
                                           mesh=seq_mesh)
            if is_empty(scribbles):
                # Perfect prediction: the robot found nothing to
                # correct; the round passes with the mask unchanged.
                rec.update(skipped=True, propagated=False, frame=None,
                           interact_s=0.0)
                t0 = time.perf_counter()
                sess.submit_masks(sess._pred)
            else:
                t0 = time.perf_counter()
                pred_masks, next_frames, idx = processor.interact(scribbles)
                rec.update(skipped=False, propagated=next_frames is None,
                           frame=idx, interact_s=time.perf_counter() - t0)
                t0 = time.perf_counter()
                sess.submit_masks(pred_masks, next_frames)
            rec["metrics_s"] = time.perf_counter() - t0
            rounds.append(rec)
            if save_mask and out_path and not rec["skipped"]:
                _save_masks(out_path, rec["round"], name, pred_masks)
    summary = sess.get_global_summary(
        save_file=path.join(out_path, "summary.json")
        if out_path and write_summary else None)
    summary["records"] = sess.get_report()
    summary["rounds"] = rounds
    return summary


def run_local_interactive_fleet(prop_net, fuse_net, s2m_net, sequences: Dict,
                                max_nb_interactions: int = 8,
                                max_time_per_interaction: int = 30,
                                mem: MemoryConfig = MemoryConfig(),
                                out_path: Optional[str] = None,
                                save_mask: bool = False,
                                devices=None) -> Dict:
    """run_local_interactive with the sequences fanned out over devices
    (default every CUDA device), one whole session per sequence on one
    device (eval/fleet.py), each device with its own prepared copy of
    the nets; the per-sequence J&F trajectories merge into one summary.
    Robot state is per sequence, so each sequence's protocol is the
    serial run's; only wall-clock times differ. Sharded sessions span
    devices and a fleet pins one session per device, so the two are
    exclusive."""
    from mivos_tpu_torch.eval.davis_metrics import summarize_session
    from mivos_tpu_torch.eval.fleet import fleet_map
    from mivos_tpu_torch.serve.server import session_devices

    if mem.bank_sharded or mem.object_sharded:
        raise ValueError("fleet evaluation and sharded sessions are "
                         "mutually exclusive (one session per device)")
    devices = session_devices(devices)
    nets = prepared_copies((prop_net, fuse_net, s2m_net), devices)

    def one(name, dev):
        return run_local_interactive(
            *nets[dev], {name: sequences[name]},
            max_nb_interactions=max_nb_interactions,
            max_time_per_interaction=max_time_per_interaction, mem=mem,
            out_path=out_path if save_mask else None, save_mask=save_mask,
            device=dev, write_summary=False)

    records, rounds = {}, []
    for r in fleet_map(one, list(sequences), devices=devices):
        records.update(r["records"])
        rounds += r["rounds"]
    summary = summarize_session(
        records, max_time=max_nb_interactions * max_time_per_interaction)
    summary["records"], summary["rounds"] = records, rounds
    if out_path:
        os.makedirs(out_path, exist_ok=True)
        with open(path.join(out_path, "summary.json"), "w") as f:
            json.dump({k: v for k, v in summary.items()
                       if k not in ("records", "rounds")}, f, indent=2)
    return summary


def run_local_interactive_davis(prop_net, fuse_net, s2m_net, davis_root: str,
                                max_nb_interactions: int = 8,
                                max_time_per_interaction: int = 30,
                                mem: MemoryConfig = MemoryConfig(),
                                subset: str = "trainval",
                                imset: str = "2017/val.txt",
                                out_path: Optional[str] = None,
                                save_mask: bool = False,
                                device: torch.device | str = "cuda",
                                mesh: Optional[Mesh] = None,
                                fleet: bool = False) -> Dict:
    """run_local_interactive over the on-disk DAVIS split: ground-truth
    labels load up front, videos lazily per sequence. Scores are not
    comparable to the official AUC-J&F (a different scribble
    simulator), but are stable across runs of this robot. fleet: one
    session per sequence per CUDA device (run_local_interactive_fleet)."""
    dataset = DAVISTestDataset(path.join(davis_root, subset), imset=imset)
    sequences = {}
    for i, name in enumerate(dataset.videos):
        lab, ids = dataset.load_labels(i)
        gt = np.zeros(lab.shape, np.int32)
        for k, obj in enumerate(ids):          # ids renumbered 1..K,
            gt[lab == obj] = k + 1             # matching the processor
        loader = (lambda j=i: np.asarray(dataset[j]["rgb"]))
        sequences[name] = (loader, gt, len(ids))
    if fleet:
        return run_local_interactive_fleet(
            prop_net, fuse_net, s2m_net, sequences,
            max_nb_interactions=max_nb_interactions,
            max_time_per_interaction=max_time_per_interaction, mem=mem,
            out_path=out_path, save_mask=save_mask)
    return run_local_interactive(
        prop_net, fuse_net, s2m_net, sequences,
        max_nb_interactions=max_nb_interactions,
        max_time_per_interaction=max_time_per_interaction, mem=mem,
        out_path=out_path, save_mask=save_mask, device=device, mesh=mesh)


def _save_masks(out_path: str, user_iter: int, seq: str,
                pred_masks: np.ndarray) -> None:
    seq_path = path.join(out_path, str(user_iter), seq)
    os.makedirs(seq_path, exist_ok=True)
    for i in range(len(pred_masks)):
        save_indexed_png(path.join(seq_path, f"{i:05d}.png"), pred_masks[i])
