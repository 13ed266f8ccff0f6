"""Process groups for the sharded step, and the weak-scaling report
(counterpart of ``semantic_dsp_map_tpu/parallel/distributed.py``).

  - :func:`initialize`: ``torch.distributed.init_process_group`` with this
    package's device rule: with nothing given, NCCL on ``cuda:LOCAL_RANK``
    (raises without a CUDA device); the CPU only by name (``device="cpu"``,
    under gloo).  The backend follows the device (:func:`backend_of`).
  - :func:`spawn_ranks`: D local ranks as processes, in one group on a free
    port, every child joined under a timeout.
  - :func:`weak_scaling_report`: particle updates/s of the sharded step at
    n ranks on an n-fold workload against the single-device map on the
    base workload, both captured on the card.

Run as a module for the report::

    python -m semantic_dsp_map_tpu_torch.parallel.distributed --devices 1
    python -m semantic_dsp_map_tpu_torch.parallel.distributed --devices 2 \\
        --device cpu

On one host the ranks share its cores (or its card), so the efficiency is
no scaling figure: it says what the routes and halos cost there.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import FilterParams, tiny_test_config
from ..frontend import FrameInput, MaskKpts, build_frame_input
from ..labels import LabelRegistry
from ..map import SemanticDSPMap
from ..state import init_map_state, resolve_device
from ..timing import card_line
from .shard_step import build_shard_step, shard_caps
from .sharding import shard_state


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_of(device: torch.device) -> str:
    """The process-group backend of a device: NCCL on the card, gloo on the
    CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def initialize(device=None, rank: Optional[int] = None, world_size: Optional[int] = None,
               init_method: Optional[str] = None, timeout: Optional[float] = None) -> torch.device:
    """Join the default process group (backend ``backend_of(device)``);
    returns this rank's device.

    ``device=None`` means ``cuda:LOCAL_RANK`` and raises without a CUDA
    device.  ``rank`` / ``world_size`` default to ``RANK`` / ``WORLD_SIZE`` (0 and 1
    without them); ``init_method`` to ``env://`` where ``MASTER_ADDR`` is
    set, else, for one rank, a free port on 127.0.0.1.  ``timeout`` (s)
    bounds every collective."""
    if device is None:
        resolve_device(None)  # raises without a CUDA device
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://127.0.0.1:{free_port()}"
        else:
            raise ValueError("more than one rank needs init_method or MASTER_ADDR / MASTER_PORT")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend_of(device), init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return device


@contextlib.contextmanager
def one_rank(device):
    """Inside the block a default group exists: the caller's, or a group of
    this process alone on ``device``, destroyed at the end of the block."""
    if dist.is_initialized():
        yield
        return
    initialize(device=device, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(fn, args, rank, D, device, port, timeout, results):
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
    initialized = False
    try:
        initialize(dev, rank=rank, world_size=D,
                   init_method=f"tcp://127.0.0.1:{port}", timeout=timeout)
        initialized = True
        results.put((rank, True, fn(dev, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if initialized:
            dist.destroy_process_group()


def spawn_ranks(fn, D: int, device=None, timeout: float = 300.0, args: Sequence = ()) -> list:
    """Run ``fn(rank_device, *args)`` in D new processes, the ranks of one
    process group on a free port of 127.0.0.1, and return their results in
    rank order.  ``fn`` and ``args`` must pickle (``fn`` a module-level
    function of a module the children can import).  ``device=None`` means
    the card (rank r on ``cuda:r``, under NCCL) and raises without a CUDA
    device; the CPU (gloo) is asked for by name (``"cpu"``).  Each child
    runs one CPU thread.  Raises if a rank raises or dies, or if the ranks
    take longer than ``timeout`` seconds; no child outlives the call."""
    device = resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, tuple(args), r, D, str(device), port, timeout, results))
             for r in range(D)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    done, errors = {}, {}
    try:
        while len(done) + len(errors) < D and not errors:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{D} ranks took more than {timeout} s; reported: {sorted(done)}")
            try:
                r, ok, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0) and r not in done:
                        errors[r] = f"rank {r} exited with code {p.exitcode} without a result"
                continue
            (done if ok else errors)[r] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
    if errors:
        raise RuntimeError("".join(f"rank {r} failed:\n{e}\n" for r, e in sorted(errors.items())))
    return [done[r] for r in range(D)]


# ---------------------------------------------------------------------------
# Weak scaling
# ---------------------------------------------------------------------------


def _base_config(preset: str):
    """The per-rank (base) workload.  ``tiny`` is fast and so small that the
    routes' fixed costs dominate; ``medium`` gives each rank a 65k-voxel slab
    and a 192 x 256 image so that the work is real."""
    if preset == "tiny":
        return tiny_test_config()
    if preset == "medium":
        return tiny_test_config(
            voxel_num_axis_x_n=6, voxel_num_axis_y_n=4, voxel_num_axis_z_n=6,
            voxel_size=0.15,
            image_width=256, image_height=192,
            camera_fx=120.0, camera_fy=120.0, camera_cx=128.0, camera_cy=96.0,
            depth_range_min=0.3, depth_range_max=8.0,
            max_visible_particles=1 << 16,
            max_active_blocks=512,
            max_birth_blocks=512,
            max_moving_blocks=64,
            max_table_entries=1 << 16,
            corner_gather_blocks=128,
        )
    raise ValueError(preset)


def _grown_config(base, n: int):
    """The base workload grown n-fold: n times the z-planes and the image
    rows (fy and cy scale with the rows, so the same surface covers n times
    the pixels) and n times every capacity knob."""
    return dataclasses.replace(
        base,
        voxel_num_axis_z_n=base.voxel_num_axis_z_n + int(np.log2(n)),
        image_height=base.image_height * n,
        camera_fy=base.camera_fy * n,
        camera_cy=base.camera_cy * n,
        max_active_blocks=base.max_active_blocks * n,
        max_birth_blocks=base.max_birth_blocks * n,
        max_moving_blocks=base.max_moving_blocks * n,
        max_table_entries=base.max_table_entries * n,
        corner_gather_blocks=base.corner_gather_blocks * n,
    )


def _report_params() -> FilterParams:
    return FilterParams(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                        depth_noise_model_zero_order=0.2)


def _report_frame(cfg, registry, device) -> FrameInput:
    """A slanted static wall seen from the origin."""
    H, W = cfg.height, cfg.width
    depth = (1.0 + np.arange(H, dtype=np.float32)[:, None] / H) * np.ones((1, W), np.float32)
    f = build_frame_input(
        cfg, registry, depth,
        [MaskKpts(track_id=65535, label="static", mask=np.full((H, W), 5, np.uint8))],
        np.zeros(3, np.float32), np.array([1, 0, 0, 0], np.float32), 0.0,
    )
    return FrameInput(*(torch.as_tensor(np.asarray(a)).to(device) for a in f))


def _updates_per_sec(device, cfg, params, frames: int, sharded: bool) -> float:
    """Particle updates/s of ``frames`` frames after two warm-up frames (on
    the card the eager one and the capture): the sharded step
    (``build_shard_step``, captured on the card) on this rank of the default
    group, or the single-device map's (``SemanticDSPMap.update_from_frame``,
    captured on the card), as the JAX report times both sides jitted.  The
    clock runs from a synchronized start to the read of the summed
    counter."""
    registry = LabelRegistry.default()
    f = _report_frame(cfg, registry, device)
    if sharded:
        state = shard_state(cfg, init_map_state(cfg, seed=0, device=device), dist.get_rank(),
                            dist.get_world_size())
        shard = build_shard_step(cfg, params, registry)

        def step():
            nonlocal state
            state, _result, diag = shard(state, f)
            return diag
    else:
        dsp = SemanticDSPMap(cfg, params, registry, seed=0, device=device)

        def step():
            return dsp.update_from_frame(f)[1]
    for _ in range(2):
        step()
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    if sharded:
        dist.barrier()
    t0 = time.perf_counter()
    updates = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(frames):
        updates += step().visible_count
    total = int(updates)
    dt = time.perf_counter() - t0
    return total / dt if dt > 0 else 0.0


def weak_scaling_report(n: int, frames: int = 10, preset: str = "tiny", device=None) -> dict:
    """Weak scaling: the whole workload grows n-fold with the rank count
    (``_grown_config``), so each rank holds a constant z-slab and a constant
    row slab.  Efficiency = updates/s at n ranks / (n x updates/s of the
    single-device map on the base workload), both captured on the card.
    One rank runs in this process; more are spawned (``spawn_ranks``).

    The JAX report's per-device compiled-FLOP ratio is an XLA compile-time
    count with no PyTorch analog; in its place the report gives the per-rank
    working sets and route buckets (``shard_caps``) of the base at one rank
    and of the grown workload at n ranks."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"weak_scaling_report needs a power-of-two rank count, got {n}: the "
                         "workload grows by log2(n) z-planes of a power-of-two grid")
    device = resolve_device(device)
    params = _report_params()
    base = _base_config(preset)
    grown = _grown_config(base, n)
    ups1 = _updates_per_sec(device, base, params, frames, sharded=False)
    if n == 1:
        with one_rank(device):
            upsN = _updates_per_sec(device, grown, params, frames, True)
    else:
        upsN = spawn_ranks(_updates_per_sec, n, device, args=(grown, params, frames, True))[0]
    return {
        "devices": n,
        "updates_per_sec_1dev": int(ups1),
        "updates_per_sec_ndev": int(upsN),
        "weak_scaling_efficiency": upsN / (ups1 * n) if ups1 > 0 else 0.0,
        "caps_1dev": shard_caps(base, params, 1),
        "caps_ndev": shard_caps(grown, params, n),
        "caps_note": ("per-rank working sets and route buckets (shard_caps) in place of the JAX "
                      "report's compile-time FLOP ratio, which has no PyTorch analog"),
        "preset": preset,
        "frames": frames,
        "backend": backend_of(device),
        "device": card_line(device),
        "host_cores": os.cpu_count(),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="Weak-scaling report of the sharded step.")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: the card count, or 1 on the CPU)")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "medium"])
    ap.add_argument("--device", default=None,
                    help="default: the card (NCCL); 'cpu' for the CPU (gloo)")
    ap.add_argument("--out", help="also write the report JSON to this path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = args.devices or (torch.cuda.device_count() if device.type == "cuda" else 1)
    report = weak_scaling_report(n, preset=args.preset, device=device)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return report


if __name__ == "__main__":
    main()
