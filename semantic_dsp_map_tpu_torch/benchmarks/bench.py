"""Benchmark: full-frame map update rate on the four bench cells
(counterpart of the JAX package's ``bench.py``).

Cells (``--cells``, default all; scenes and parameters in ``scenes``):
  - ``zed2``: the reference's headline setting (BOOST 640 x 360, bbox3d);
  - ``vkitti2``: the VKITTI2 preset, superpoint mode;
  - ``vkitti2_template``: VKITTI2 with template matching and the committed
    bank ``data/templates``.  The car is a fifth of the image high
    (``scenes.synth_template_frame``), so the template stage sweeps and
    births on frame 0; the JAX bench's car never reaches the birth window,
    so this cell's counters are not comparable with that bench's.  The
    template stages run inside the captured step, their slots as
    conditional nodes (step_graph.slot_cond);
  - ``vkitti2_hostile``: 20 moving cars, a near wall, ego yaw; the move cap
    of the VKITTI2 preset binds;
  - ``zed2_sharded`` (asked for by name only): the sharded step
    (``parallel.shard_step.build_shard_step``, one CUDA graph a frame on the
    card) at one rank on the ZED2 preset's static scene, held to the
    single-device step's render frame by frame (:func:`run_sharded_check`).

Each cell builds one map, makes every frame before the clock starts, runs
the warm-up frames, synchronizes, and then repeats the timed loop ``runs``
times on the same map.  The timed loop calls ``update()`` only: no host read
and no synchronize inside it; the ``StepDiagnostics`` handles are collected
and reduced after the one synchronize that ends the loop.  A loop is timed
by the host's clock around loop and synchronize and, on the card, by CUDA
events around the loop as well.

Usage::

    python -m semantic_dsp_map_tpu_torch.benchmarks.bench [--iters 50]
        [--cells zed2,vkitti2_hostile] [--out cells.json] [--device cpu]

``--iters`` frames for zed2, half of it for the others (as the JAX bench).
Nothing is written unless ``--out`` names a file.  The last line of the
output is one JSON object with the VKITTI2 rate (the ZED2 rate beside it).
The presets are full size: they are for the card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import FilterParams, virtual_kitti2_config, zed2_config
from ..frontend import FrameInput, build_frame_input
from ..labels import LabelRegistry
from ..map import SemanticDSPMap, build_frame_step
from ..parallel.distributed import one_rank
from ..parallel.shard_step import build_shard_step
from ..parallel.sharding import gather_render, shard_state
from ..state import STATUS_GUESSED_BORN, init_map_state, resolve_device
from ..step_graph import FRAME_KERNELS, kernel_runs
from ..timing import card_line
from . import scenes

#: The committed template bank of the vkitti2_template cell.
TEMPLATES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "templates")

_PRESETS = {"zed2": zed2_config, "vkitti2": virtual_kitti2_config}

#: name -> (preset, runtime parameters, scene, timed frames from --iters,
#: template bank or None); in the order the cells run.
CELLS = {
    "zed2": ("zed2", scenes.ZED2_PARAMS, scenes.synth_zed2_frame, lambda n: n, None),
    "vkitti2": ("vkitti2", scenes.VK_PARAMS, scenes.synth_vkitti2_frame,
                lambda n: max(10, n // 2), None),
    "vkitti2_template": ("vkitti2", scenes.TPL_PARAMS, scenes.synth_template_frame,
                         lambda n: max(20, n // 2), TEMPLATES),
    "vkitti2_hostile": ("vkitti2", scenes.VK_PARAMS, scenes.synth_hostile_frame,
                        lambda n: max(10, n // 2), None),
}

def _launch_counts() -> dict:
    return {fn.__name__: kernel_runs(fn) for fn in FRAME_KERNELS}


def timed_loop(dsp: SemanticDSPMap, frames, first_t: int):
    """``update()`` on every frame, nothing else: no host read, no
    synchronize.  Returns (last result, the frames' StepDiagnostics)."""
    diags = []
    result = None
    for t, (depth, masks, pos, quat) in enumerate(frames, start=first_t):
        result, diag = dsp.update(depth, masks, pos, quat, time=t * 0.1)
        diags.append(diag)
    return result, diags


def run_config(name, cfg, params, synth, iters, warmup=3, template_path=None, device=None,
               runs=3):
    """One cell: ``warmup`` frames, then ``runs`` timed loops of ``iters``
    frames each on the same map (the scene runs on from loop to loop).

    Returns the cell's dictionary: ``sec_per_frame`` is the median over the
    runs of the host clock's time per frame, ``fps`` its inverse,
    ``particle_updates_per_sec`` the visible particles of all timed frames
    over all timed seconds (``particle_updates`` over ``seconds``),
    ``peak_diag`` the per-field maximum over all timed frames.  ``runs``
    lists every loop with its own ``peak_diag`` (the first loop's frames are
    those of the JAX bench's one loop) and, on the card, its CUDA-event
    time; the occupancy histogram and the count of NaN weights are read
    after the last one.  In template mode the cell also says how many sweeps
    each stage ran (``template_sweeps``, read from the device after the
    loops) and the most GUESSED_BORN particles seen after a warm-up frame."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    dsp = SemanticDSPMap(cfg, params, LabelRegistry.default(), device=device)
    if template_path:
        if dsp.set_template_path(template_path) <= 0:
            raise RuntimeError(f"{name}: no template loaded from {template_path}")
    frames = [synth(cfg, t) for t in range(warmup + runs * iters)]
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)

    launches0 = _launch_counts()
    guessed_born = 0
    for t in range(warmup):
        timed_loop(dsp, frames[t : t + 1], t)
        if dsp._templates is not None:
            # Warm-up frames may read: the particles a template birth leaves
            # turn UPDATED as they are observed, so they are counted here.
            n = int((dsp.state.particles.status == STATUS_GUESSED_BORN).sum())
            guessed_born = max(guessed_born, n)
    sync()

    run_rows, diags = [], []
    result = None
    for r in range(runs):
        lo = warmup + r * iters
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        result, run_diags = timed_loop(dsp, frames[lo : lo + iters], lo)
        enqueue = time.perf_counter() - t0
        if cuda:
            e1.record()
        sync()
        dt = time.perf_counter() - t0
        row = {"first_frame": lo, "seconds": dt, "sec_per_frame": dt / iters,
               "enqueue_sec_per_frame": enqueue / iters}
        if cuda:
            row["events_sec_per_frame"] = e0.elapsed_time(e1) / 1e3 / iters
        run_rows.append(row)
        diags.append(run_diags)
    launches = {k: v - launches0[k] for k, v in _launch_counts().items()}

    # Reduced only now, after the loops' synchronizes.
    fields = diags[0][0]._fields
    updates = 0
    for row, run_diags in zip(run_rows, diags):
        stacked = {f: torch.stack([getattr(d, f) for d in run_diags]) for f in fields}
        row["peak_diag"] = {f: int(stacked[f].max()) for f in fields}
        row["particle_updates"] = int(stacked["visible_count"].sum())
        updates += row["particle_updates"]
    peak_diag = {f: max(row["peak_diag"][f] for row in run_rows) for f in fields}
    seconds = sum(row["seconds"] for row in run_rows)
    per_frame = [row["sec_per_frame"] for row in run_rows]
    median = float(np.median(per_frame))

    occ = result.occ
    hist = torch.bincount((occ + 1).long().reshape(-1), minlength=4).tolist()
    out = {
        "config": name,
        "frames": iters,
        "fps": 1.0 / median,
        "particle_updates_per_sec": int(updates / seconds),
        "sec_per_frame": median,
        "peak_diag": peak_diag,
        "sec_per_frame_min": min(per_frame),
        "sec_per_frame_max": max(per_frame),
        "runs": run_rows,
        "seconds": seconds,
        "particle_updates": updates,
        "warmup": warmup,
        "card": card_line(device),
        "occ_histogram": {str(k - 1): int(c) for k, c in enumerate(hist)},
        "nan_weights": int(torch.isnan(dsp.state.particles.weight).sum()),
        "kernel_launches": launches,
    }
    if cuda:
        out["events_sec_per_frame"] = float(np.median(
            [row["events_sec_per_frame"] for row in run_rows]))
    if dsp._templates is not None:
        records = dsp._templates.records
        out["template_sweeps"] = {stage: int(r.count) for stage, r in records.items()}
        out["guessed_born_in_warmup"] = guessed_born
    return out


#: The sharded check's runtime parameters (those of the JAX bench's check).
SHARDED_PARAMS = dict(
    detection_probability=0.8, noise_number=0.2, nb_ptc_num_per_point=1,
    occupancy_threshold=0.15, if_consider_depth_noise=True,
    depth_noise_model_first_order=0.02, depth_noise_model_zero_order=0.3,
)


def run_sharded_check(iters: int = 8, device=None) -> dict:
    """The sharded step on the ZED2 preset's static scene (the person's mask
    left out: the step's move jitter comes from a per-rank generator, so
    only a scene without movers compares bit for bit), in a process group of
    one rank unless the caller has a group: each of ``iters`` frames runs
    through the single-device step and the sharded step in turn, and the
    two renders' occ, label and track must be equal, else it raises.  Then
    ``iters`` more sharded frames are timed (host clock around the loop and
    one synchronize); on the card the sharded step replays its graph from
    the second frame on.  Returns the cell's dictionary, with the kernel
    launches of the sharded frames alone (``step_graph.kernel_runs``)."""
    device = resolve_device(device)
    cfg = _PRESETS["zed2"]()
    params = FilterParams(**SHARDED_PARAMS)
    registry = LabelRegistry.default()

    def frame(t):
        depth, masks, pos, quat = scenes.synth_zed2_frame(cfg, t)
        masks = [m for m in masks if m.label == "static"]
        f = build_frame_input(cfg, registry, depth, masks, pos, quat, t * 0.1)
        return FrameInput(*(torch.as_tensor(np.asarray(a)).to(device) for a in f))

    frames = [frame(t) for t in range(iters)]
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    plain = build_frame_step(cfg, params, registry)
    s1 = init_map_state(cfg, seed=0, device=device)
    with one_rank(device):
        D = dist.get_world_size()
        sharded = build_shard_step(cfg, params, registry)
        s2 = shard_state(cfg, init_map_state(cfg, seed=0, device=device), dist.get_rank(), D)
        launches = dict.fromkeys(_launch_counts(), 0)
        parted = []
        for t, f in enumerate(frames):
            s1, r1, _ = plain(s1, f)
            before = _launch_counts()
            s2, r2, _ = sharded(s2, f)
            launches = {k: launches[k] + v - before[k] for k, v in _launch_counts().items()}
            r2 = gather_render(r2)
            parted += [(t, k) for k in ("occ", "label", "track")
                       if not torch.equal(getattr(r1, k), getattr(r2, k))]
        del s1, r1
        if parted:
            raise AssertionError(f"zed2_sharded: the sharded render parts from the single-device "
                                 f"step's at (frame, field) {parted}")
        before = _launch_counts()
        s2, r2, _ = sharded(s2, frames[0])
        sync()
        t0 = time.perf_counter()
        for t in range(iters):
            s2, r2, _ = sharded(s2, frames[t % len(frames)])
        sync()
        dt = time.perf_counter() - t0
        launches = {k: launches[k] + v - before[k] for k, v in _launch_counts().items()}
        graphs = sorted(list(key) for key in sharded.static.graphs)
        del sharded  # its graphs go before the communicator they recorded
    return {
        "config": f"zed2_sharded_ranks{D}",
        "ranks": D,
        "frames": iters,
        "fps": iters / dt,
        "sec_per_frame": dt / iters,
        "render_equal_vs_plain": True,
        "kernel_launches": launches,
        "graphs": graphs,
        "card": card_line(device),
    }


#: Cells asked for by name only (not in the default list): name -> a
#: function of the device that returns the cell's dictionary.
BY_NAME = {"zed2_sharded": run_sharded_check}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """The CLI; returns {cell name: cell dictionary}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50,
                    help="timed frames of a zed2 loop; the other cells run half of it")
    ap.add_argument("--cells", default=None,
                    help="comma list of cells (default: all of %s; by name only: %s)"
                    % (",".join(CELLS), ",".join(BY_NAME)))
    ap.add_argument("--out", default=None, help="write the cells' dictionaries to this JSON file")
    ap.add_argument("--device", default=None,
                    help="torch device of the map (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    names = args.cells.split(",") if args.cells else list(CELLS)
    unknown = [n for n in names if n not in CELLS and n not in BY_NAME]
    if unknown:
        ap.error(f"unknown cells {unknown}; known: {list(CELLS) + list(BY_NAME)}")
    device = resolve_device(args.device)

    details = {}
    for name in names:
        if name not in CELLS:
            cell = details[name] = BY_NAME[name](device=device)
            print(f"[bench] {name}: {cell['frames']} frames equal to the single-device step "
                  f"(occ, label, track) at {cell['ranks']} rank(s), then "
                  f"{1e3 * cell['sec_per_frame']:.3f} ms/frame (host clock, one synchronize); "
                  f"launches {cell['kernel_launches']} ({cell['card']})", flush=True)
            continue
        preset, params, synth, n_frames, tpl = CELLS[name]
        cell = run_config(name, _PRESETS[preset](), FilterParams(**params), synth,
                          n_frames(args.iters), template_path=tpl, device=device)
        details[name] = cell
        events = cell.get("events_sec_per_frame")
        print(f"[bench] {name}: {cell['frames']} frames x {len(cell['runs'])} runs after "
              f"{cell['warmup']}: "
              f"{1e3 * cell['sec_per_frame']:.3f} ms/frame (host clock, one synchronize a loop; "
              f"median of the runs, min {1e3 * cell['sec_per_frame_min']:.3f}, "
              f"max {1e3 * cell['sec_per_frame_max']:.3f})"
              + (f", {1e3 * events:.3f} ms/frame by CUDA events" if events is not None else "")
              + f"; {cell['particle_updates_per_sec']} particle updates/s; peak {cell['peak_diag']}; "
              f"occ {cell['occ_histogram']}; NaN weights {cell['nan_weights']} ({cell['card']})",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(details, f, indent=1)

    headline = {"unit": "frames/s"}
    if "vkitti2" in details:
        headline.update(metric="vkitti2_frames_per_sec", value=details["vkitti2"]["fps"])
    if "zed2" in details:
        headline["zed2_fps"] = details["zed2"]["fps"]
    headline["card"] = card_line(device)
    print(json.dumps(headline))
    return details


if __name__ == "__main__":
    main()
