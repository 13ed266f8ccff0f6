"""Per-stage timing harness — the analog of the reference's VERBOSE_MODE
chrono spans (semantic_dsp_map.h:916-952), with the same stage breakdown:
objects / labeled cloud / prediction / observe (visibility+PHD) /
birth+resample / render (counterpart of ``semantic_dsp_map_tpu/profiling.py``).

Stages are timed as *cumulative prefixes* of the real frame step
(``map.build_frame_step(..., stop_after=k)``): the delta between prefix k and
prefix k-1 is the cost of stage k.  PyTorch runs eagerly, so a prefix is the
very code of the full step up to that stage.  The work of a stage depends on
what the map holds (a map that never births has nothing to observe), so
every prefix is timed on a copy of the state of ONE map that the whole step
drives: frame after frame, each prefix runs on a copy, then the whole step
moves the map on.

For each prefix three times are taken per frame, each the median over
``--iters`` frames after one warm-up frame (the host's clock varies from
frame to frame on a shared machine, so take enough frames):
  - ``device``: CUDA events around the frame (on the CPU: the wall time);
  - ``wall``: the host clock from the call to the end of a synchronize;
  - ``enqueue``: the host clock until the call returned, before the
    synchronize.  Where ``enqueue`` is close to ``wall`` the host, not the
    device, sets the frame time.
Beside them: ``pack_frame`` (host numpy) and the host-to-device copy of the
packed buffer alone, the part of ``SemanticDSPMap.update`` that precedes the
step; and the host time that the stage boundaries themselves add to a frame.

Usage:
    python -m semantic_dsp_map_tpu_torch.profiling [--config vkitti2] [--iters 5]
        [--stages 0,3,5] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import (
    FilterParams,
    kitti360_config,
    tiny_test_config,
    virtual_kitti2_config,
    zed2_config,
)
from .frontend import MaskKpts, pack_frame, static_label_table
from .labels import LabelRegistry
from .map import STAGES, build_frame_step, unpack_frame
from .state import MapState, init_map_state, resolve_device
from .timing import Span, card_line

_CONFIGS = {
    "vkitti2": virtual_kitti2_config, "zed2": zed2_config,
    "kitti360": kitti360_config, "tiny": tiny_test_config,
}


def profile_frame(cfg):
    """The frame every prefix is stepped on: a noisy wall 8-9 m ahead, one
    static mask, the camera at the origin.  Returns the arguments of
    ``pack_frame`` after (cfg, registry)."""
    H, W = cfg.image_height, cfg.image_width
    rng = np.random.RandomState(0)
    depth = np.full((H, W), 8.0, np.float32) + rng.rand(H, W).astype(np.float32)
    static = np.full((H, W), 6, np.uint8)
    return (depth, [MaskKpts(track_id=65535, label="static", mask=static)],
            np.zeros(3, np.float32), np.array([1, 0, 0, 0], np.float32), 0.0)


def clone_state(state: MapState) -> MapState:
    """A deep copy of the state, generator included (the step updates the
    store in place and draws from the generator)."""

    def clone(obj):
        if isinstance(obj, torch.Tensor):
            return obj.clone()
        if isinstance(obj, torch.Generator):
            g = torch.Generator(device=obj.device)
            g.set_state(obj.get_state())
            return g
        return dataclasses.replace(
            obj, **{f.name: clone(getattr(obj, f.name)) for f in dataclasses.fields(obj)})

    return clone(state)


def time_prefixes(cfg, params, registry, frame, stages: Sequence[int], iters: int,
                  device) -> List[dict]:
    """Drive one map for ``iters`` frames with the whole step (after one
    warm-up frame); on each frame, time every prefix in ``stages`` on a copy
    of the map's state.  Returns one row per prefix: median ms per frame."""
    full = build_frame_step(cfg, params, registry)
    steps = {k: build_frame_step(cfg, params, registry, stop_after=k) for k in stages}
    state = init_map_state(cfg, seed=0, device=device)
    # Untimed first: libraries load and initialise at an op's first use.
    state, _, _ = full(state, frame)
    for k in stages:
        steps[k](clone_state(state), frame)
    spans = {k: [] for k in stages}
    for _ in range(iters):
        for k in stages:
            trial = clone_state(state)
            with Span(device) as span:
                steps[k](trial, frame)
            spans[k].append(span)
            del trial
        state, _, _ = full(state, frame)
    med = lambda k, name: float(np.median([getattr(sp, name) for sp in spans[k]]))
    return [dict(stage=STAGES[k], device_ms=med(k, "device_ms"), wall_ms=med(k, "wall_ms"),
                 enqueue_ms=med(k, "enqueue_ms")) for k in stages]


def time_ingest(cfg, registry, frame_args, iters: int, device) -> dict:
    """``pack_frame`` and the host-to-device copy of its buffer, each alone;
    median ms per frame."""
    buf = pack_frame(cfg, registry, *frame_args)
    host = torch.from_numpy(buf)
    host.to(device)
    pack_ms, copy_ms = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        pack_frame(cfg, registry, *frame_args)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
        with Span(device) as span:
            host.to(device)
        copy_ms.append(span.wall_ms)
    return dict(pack_ms=float(np.median(pack_ms)), copy_ms=float(np.median(copy_ms)),
                bytes=int(buf.nbytes))


def time_stage_bookkeeping(reps: int = 2000) -> float:
    """Host microseconds per frame of what the stage boundaries add to the
    whole step: five ``stop_after`` compares and three rebuilds of the
    ``MapState`` dataclass.  Neither touches a tensor's data, so a tiny state
    on the CPU gives the cost at any size."""
    state = init_map_state(tiny_test_config(), seed=0, device="cpu")
    stop_after = len(STAGES) - 1
    t0 = time.perf_counter()
    for _ in range(reps):
        for k in range(5):
            if stop_after == k:
                raise AssertionError("unreachable")
        for _ in range(3):
            state = dataclasses.replace(state, particles=state.particles, objects=state.objects)
    return (time.perf_counter() - t0) / reps * 1e6


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """The CLI; prints the table and returns its rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="vkitti2", choices=sorted(_CONFIGS))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--stages", default=None,
                    help="comma list of stage indices to time (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = _CONFIGS[args.config]()
    params = FilterParams(nb_ptc_num_per_point=3, if_consider_depth_noise=True,
                          depth_noise_model_zero_order=0.2,
                          depth_noise_model_first_order=0.01)
    registry = LabelRegistry.default()
    frame_args = profile_frame(cfg)
    static_table = torch.from_numpy(static_label_table(registry)).to(device)
    buf = torch.from_numpy(pack_frame(cfg, registry, *frame_args)).to(device)
    frame = unpack_frame(cfg, static_table, buf)

    where = card_line(device)
    print(f"config={args.config} grid={cfg.nx}x{cfg.ny}x{cfg.nz} "
          f"K={cfg.slots_per_voxel} img={cfg.width}x{cfg.height} V={cfg.num_voxels} "
          f"device={where} iters={args.iters}")

    sel = ([int(s) for s in args.stages.split(",")] if args.stages
           else list(range(len(STAGES))))
    rows = time_prefixes(cfg, params, registry, frame, sel, args.iters, device)
    prev = dict(device_ms=0.0, wall_ms=0.0)
    for row in rows:
        print(f"prefix<={row['stage']:<15} device {row['device_ms']:9.3f} ms "
              f"(+{row['device_ms'] - prev['device_ms']:8.3f})   "
              f"wall {row['wall_ms']:9.3f} ms (+{row['wall_ms'] - prev['wall_ms']:8.3f})   "
              f"enqueue {row['enqueue_ms']:9.3f} ms", flush=True)
        prev = row
    ing = time_ingest(cfg, registry, frame_args, args.iters, device)
    print(f"ingest alone: pack_frame {ing['pack_ms']:.3f} ms (host numpy), "
          f"host-to-device copy of {ing['bytes']} bytes {ing['copy_ms']:.3f} ms", flush=True)
    rows.append(dict(stage="ingest", **ing))
    book_us = time_stage_bookkeeping()
    print(f"stage boundaries of the whole step (5 stop_after compares, 3 MapState rebuilds): "
          f"{book_us:.2f} us of host time per frame", flush=True)
    rows.append(dict(stage="stage_bookkeeping", host_us=book_us))
    return rows


if __name__ == "__main__":
    main()
