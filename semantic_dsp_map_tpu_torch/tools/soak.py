"""KITTI-360-scale memory + scroll soak (SETTING 0: 16.8M voxels, 117M
particle slots; counterpart of ``tools/soak_kitti360.py``).

Drives the static-mode map along a synthetic street, checkpoints half-way,
restores into a second map, and verifies:
  - the big config fits and runs on one card over the whole drive;
  - scroll invalidation: regions left behind become unknown again; occupied
    voxels track the ego;
  - checkpoint/resume: five frames after the restore the resumed map's
    occupancy equals the first run's at the same frame.

Writes the report as JSON (default ``chiprun_out/SOAK_KITTI360.json``) and
exits nonzero if a check fails.  The map runs on the card unless ``--device``
names another device:
    python -m semantic_dsp_map_tpu_torch.tools.soak [--frames 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..checkpoint import load_checkpoint, save_checkpoint
from ..config import FilterParams, MapConfig, kitti360_config
from ..frontend import MaskKpts
from ..map import SemanticDSPMap
from ..state import MapState, resolve_device
from ..viz import voxel_positions

#: Frames replayed after the restore before the two runs are compared.
RESUME_FRAMES = 5


def make_frame(cfg: MapConfig, t: int, speed: float):
    """Synthetic street: ground plane + two side walls, ego driving +z."""
    H, W = cfg.height, cfg.width
    v = np.arange(H, dtype=np.float32)[:, None]
    u = np.arange(W, dtype=np.float32)[None, :]
    depth = np.full((H, W), 35.0, np.float32)
    ground = cfg.fy * 1.55 / np.maximum(v - cfg.cy, 1e-3)
    depth = np.minimum(depth, np.where(v > cfg.cy, ground, depth))
    xr = (u - cfg.cx) / cfg.fx
    wall = np.where(np.abs(xr) > 1e-3, 4.0 / np.maximum(np.abs(xr), 1e-3), 35.0)
    depth = np.minimum(depth, wall.astype(np.float32))
    rng = np.random.RandomState(t)
    depth += rng.randn(H, W).astype(np.float32) * 0.02
    static = np.broadcast_to(
        np.where(np.abs(xr) > 0.12, 5, 6).astype(np.uint8), (H, W)
    ).copy()  # walls/road
    masks = [MaskKpts(track_id=65535, label="static", mask=static)]
    pos = np.array([0.0, 0.0, speed * t], np.float32)
    quat = np.array([1.0, 0, 0, 0], np.float32)
    return depth, masks, pos, quat


def soak_params() -> FilterParams:
    """One particle per point and no template stage: the drive is
    deterministic given the generator's state, which the checkpoint carries."""
    return FilterParams(
        if_consider_depth_noise=True, nb_ptc_num_per_point=1,
        depth_noise_model_zero_order=0.2, depth_noise_model_first_order=0.01,
        occupancy_threshold=0.3,
    )


def state_bytes(state: MapState) -> int:
    """Bytes of every tensor of the state (no copy)."""

    def leaves(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                yield from leaves(v)
            elif isinstance(v, torch.Tensor):
                yield v

    return sum(t.numel() * t.element_size() for t in leaves(state))


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def run_soak(cfg: MapConfig, params: FilterParams, frames: int, speed: float, device=None,
             verbose: bool = True, frame_fn=make_frame) -> dict:
    """The drive, the checkpoint at frame ``frames // 2``, the restore into a
    second map and ``RESUME_FRAMES`` more frames; returns the report.
    ``sec_per_frame`` is the whole drive over its frames (frame synthesis and
    the checkpoint included); ``frame_ms_median`` is ``update()`` alone, to
    the end of the device's work.
    ``frame_fn(cfg, t, speed)`` makes frame ``t`` (a smaller street for a
    smaller map)."""
    device = resolve_device(device)
    n, half = frames, frames // 2
    if half + RESUME_FRAMES > n - 1:
        raise ValueError(f"--frames must be at least {2 * RESUME_FRAMES + 2}, got {n}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    dsp = SemanticDSPMap(cfg, params, device=device)

    with tempfile.TemporaryDirectory(prefix="soak_ckpt_") as ckpt:
        t0 = time.perf_counter()
        occ_half = occ_half_plus = None
        frame_ms = []
        for t in range(n):
            d, m, p, q = frame_fn(cfg, t, speed)
            t_frame = time.perf_counter()
            result, diag = dsp.update(d, m, p, q, time=t * 0.1)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            frame_ms.append((time.perf_counter() - t_frame) * 1e3)
            if t == half:
                save_checkpoint(ckpt, dsp.state, step=t)
                occ_half = result.occ.cpu().numpy()
                if verbose:
                    print(f"checkpointed at frame {t} "
                          f"({_dir_bytes(ckpt) / 2**20:.0f} MB)", flush=True)
            if t == half + RESUME_FRAMES:
                occ_half_plus = result.occ.cpu().numpy()
            if verbose and t % 50 == 0:
                occ = result.occ.cpu().numpy()
                print(f"frame {t}: occupied={int((occ == 1).sum())} "
                      f"free={int((occ == 0).sum())}", flush=True)
        occ = result.occ.cpu().numpy()  # the device-to-host copy is the sync
        total = time.perf_counter() - t0

        vp = voxel_positions(cfg, dsp.state.scroll)
        ego_z = speed * (n - 1)
        occ_sel = occ == 1
        zs = vp[occ_sel][:, 2]

        # Scroll correctness: every occupied voxel lies within the map extent
        # of the CURRENT ego position; regions left behind are unknown again.
        half_z = cfg.map_half_extent[2]
        in_window = bool(np.all(np.abs(zs - ego_z) <= half_z + cfg.voxel_size))
        behind = vp[:, 2] < ego_z - half_z - 1.0
        behind_unknown = bool((occ[behind] == -1).all()) if behind.any() else True

        # Checkpoint/restore: resume from half and replay to half+5; the
        # restored run must reproduce the occupancy of the first run.
        checkpoint_bytes = _dir_bytes(ckpt)
        dsp2 = SemanticDSPMap(cfg, params, device=device)
        dsp2.state = load_checkpoint(ckpt, cfg, device=device)
        for t in range(half + 1, half + RESUME_FRAMES + 1):
            d, m, p, q = frame_fn(cfg, t, speed)
            r2, _ = dsp2.update(d, m, p, q, time=t * 0.1)
        occ2 = r2.occ.cpu().numpy()

    report = dict(
        frames=n,
        meters=round(speed * n, 1),
        sec_per_frame=round(total / n, 3),
        frame_ms_median=round(float(np.median(frame_ms)), 3),
        fps=round(n / total, 2),
        occupied_final=int(occ_sel.sum()),
        occupied_at_checkpoint=int((occ_half == 1).sum()),
        occupied_in_ego_window=in_window,
        behind_region_unknown=behind_unknown,
        resumed_occupied_half_plus_5=int((occ2 == 1).sum()),
        resumed_occ_equal=bool(np.array_equal(occ2, occ_half_plus)),
        checkpoint_mb=round(checkpoint_bytes / 2**20, 1),
        state_bytes=state_bytes(dsp.state),
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    )
    if device.type == "cuda":
        report["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(device))
    return report


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """The CLI; writes and returns the report, and raises if a check failed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--speed", type=float, default=0.7, help="m/frame")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "SOAK_KITTI360.json"),
                    help="where the JSON report goes")
    args = ap.parse_args(argv)

    report = run_soak(kitti360_config(), soak_params(), args.frames, args.speed, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    failed = [k for k in ("occupied_in_ego_window", "behind_region_unknown", "resumed_occ_equal")
              if not report[k]]
    if failed:
        raise AssertionError(f"soak checks failed: {failed}")
    return report


if __name__ == "__main__":
    main()
