#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # all phases, as a check of a checkout
    python3 chip_smoke.py --phase kernels   # build + per-kernel checks only
    python3 chip_smoke.py --profile         # all phases + a torch.profiler breakdown
    python3 chip_smoke.py --against DIR     # also time both PHD passes, the render,
                                            # the front scan and the gather built from
                                            # DIR's sources (another version of csrc/),
                                            # in turns, in this call
    python3 chip_smoke.py --record-expected # print where the card parts from
                                            # data/bench_expected/ instead of failing

Phases (any failure raises, and the script exits nonzero):
  0. print the card (nvidia-smi name and power limit, torch's device name);
  1. build the CUDA kernels from semantic_dsp_map_tpu_torch/csrc;
  2. check each of the seven kernels against its plain PyTorch version on
     the card and time both with CUDA events, beside the kernel's bound
     (bytes over the memory rate or operations over their peak rate,
     whichever is larger, from this run's inputs): the five frame kernels at
     VKITTI2 shapes, at ZED2 shapes (BOOST 640x360, R = 3, K = 3) and at the
     coda preset's (960x540, K = 3 at 8.4M voxels), the
     gather and x2 probe kernels at the probes' shapes, in turns with the
     PyTorch call that computes the same function (the gather also with its
     indices sorted); the movable scan also a launch inside a CUDA graph
     (no host time); then [launch]: each of the seven
     wrappers' host time
     per launch beside the bare ctypes call of its entry point and beside
     torch.mul;
  3. check the CUDA path against the CPU path on the tiny dynamic scene, on
     the tiny ZED2 scene (independent filter off and on), on the small
     template scene (a template birth fires) and on the reduced hostile
     scene (20 movers, the move cap binding), every kernel on; and the
     neighbour-smoothed render on a random state, against the CPU at ZED2
     shapes and timed on the card at VKITTI2 and ZED2 shapes;
  3a. [expected]: hold the card to the full-size files data/bench_expected/:
     8 frames each of the hostile and the vkitti2 scene, and of the hostile
     scene with its cars off the voxel boundaries, at the VKITTI2 preset
     with prediction_stddev=0.0, all nine counters and the counts of
     occupied, free and unknown voxels as the JAX package gave them on the
     CPU; a quantity that a float tie decides is held to the value recorded
     beside it (the port's CPU path's, or this card's) and printed as OPEN;
  3b. [bench]: benchmarks.bench.main --iters 50 on the card: the four cells
     (zed2, vkitti2, vkitti2_template, vkitti2_hostile) at full width, 3
     timed loops each with one synchronize a loop; every kernel once per
     frame in every cell, the hostile cell's move cap binding, each cell's
     peak counters printed beside those the JAX package recorded;
  4. drive the main paths: SemanticDSPMap.update() on the default VKITTI2
     preset, on the default ZED2 preset, on the VKITTI2 preset with
     template matching (vkitti2_template: the data/templates bank, a car
     inside the template-birth window) and on the coda preset (always-moving
     objects), each for 3 warm-up + 5 synthetic
     frames; check that every kernel ran once per frame and that the
     template birth swept, scored and made guessed particles; time the
     birth's sweep alone.  After the vkitti2 frames, one more frame's own
     pixel table, cloud and particle store go through both PHD passes, the
     candidate scan and the render alone (against their plain versions, then
     timed): a frame's data is patchy and mostly empty where the checked
     inputs are uniform.  Then the rematch path: the VKITTI2 scene with
     the car's keypoints withheld on frame 5, where the object layer's coast
     branch must run at full size.  Then the
     replay path: 13 VKITTI2 frames written
     as npz files and replayed by ``replay.main`` on the default device
     (11 mapped frames, PLY clouds read back); the KITTI-360 soak
     (``tools.soak``: the largest preset, a checkpoint and a restore); the
     stage profiler's table at VKITTI2; and the two primitive-op probe
     modules, which launch the gather and x2 kernels;
  4b. [graph]: the captured step against the eager one at full width on
     vkitti2, zed2, coda and the hostile scene: SemanticDSPMap.update()
     (frame 0 eager, frame 1 captured into a CUDA graph, replays after) in
     turns with build_frame_step on a state of its own, 10 frames, noise
     on: state (generator included), render and counters bit-equal every
     frame; both per-frame medians, host API calls a frame, device busy
     share, the memory a frame takes, and the five kernels' device time
     inside a replay (torch.profiler).  Every main path's map replays its
     graph; a path's launch counts are a wrapper's launches outside graphs
     plus those captured into a graph times its replays
     (step_graph.kernel_runs);
  5. [sharded]: the sharded step (parallel/shard_step.py) at one rank, in a
     process group of this process alone (NCCL): at the VKITTI2 preset with
     the movers, 8 frames, unpacked and packed, in turns with the
     single-device step and equal to it (integer state, voxel stamps, the
     render and the counters bit for bit, floats within 1e-6), timed with
     CUDA events; at the ZED2 preset, ``benchmarks.bench.run_sharded_check``;
     PHD passes A and B, the render, the candidate scan and the movable scan
     once a sharded frame.  Then those five kernels against their plain
     versions at the shapes a rank of a D-rank run gives them (D = 1, 2, 4,
     8; VKITTI2 and ZED2), and the weak-scaling report at one rank.
Then one JSON line with the kernels' numbers, the card again, and as the
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the package beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

#: Tolerances of the kernel checks: float outputs vs the plain version.
RTOL, ATOL = 2e-5, 1e-6

#: Peak rates of one H100 SXM that the kernels' bounds are reckoned against:
#: device memory 3.35 TB/s; f32 outside the tensor cores 67 TFLOP/s; special
#: function units (one ex2 per expf) 132 SMs x 16 lanes x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
#: The card's L2 cache.  The kernel timings re-run on the same tensors, so
#: inputs that fit it are read from L2, not from device memory, after the
#: first launch: such a time is a warm-cache time held against a bound
#: reckoned at the device-memory rate, and is printed and recorded as one.
L2_BYTES = 50e6
#: f32 operations of one PHD term around its expf: three differences, three
#: scalings, the squared norm (5), the -0.5 factor, the exp's range
#: reduction (about 3), the coefficient, the weight or factor, the sum.
PHD_FLOPS_PER_TERM = 17

TEMPLATES = REPO / "data" / "templates"
EXPECTED = REPO / "data" / "bench_expected"


def bench_scenes():
    """The bench's scenes and parameter sets (the package's
    benchmarks/scenes.py; imported late, as everything of the package)."""
    from semantic_dsp_map_tpu_torch.benchmarks import scenes

    return scenes


def cuda_ms(fn, reps: int, queued: bool = False, setup=None) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs (after one warm-up).
    ``setup`` runs before each of them, outside the events: a kernel that
    works in place gets its input back.
    The events bracket the call, so with an idle device the time holds what
    the host takes to make the launch (a kernel wrapper's checks and
    allocations, tens of microseconds) as well as the kernel.  With
    ``queued`` a device-side spin of about a millisecond is enqueued first:
    the launch is already waiting when the device gets to the first event,
    and the time is the device's alone."""
    import torch

    if setup is not None:
        setup()
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if setup is not None:
            setup()
        if queued:
            torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device ms a call of ``fn`` takes inside a CUDA graph: ``launches``
    calls captured into one graph, replayed ``reps`` times between CUDA
    events; the median over the launches.  No host time is in it: the
    launches are enqueued by one replay.  ``fn`` must give the same result
    every call (it does not work in place)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cache_note(report_entry, prefix, *inputs) -> str:
    """Record under ``prefix`` + warm_cache whether a kernel's inputs fit the
    L2 cache (its timed launches then read them from there) and return the
    words that say so on its line."""
    n = nbytes(*inputs)
    report_entry[prefix + "warm_cache"] = n < L2_BYTES
    return f" [inputs {n / 1e6:.1f} MB fit the L2: warm-cache time]" if n < L2_BYTES else ""


@contextlib.contextmanager
def using_library(lib):
    """Inside the block the kernel wrappers launch from ``lib``, a build of
    another version of the sources, instead of the package's own library."""
    from semantic_dsp_map_tpu_torch.ops import cuda_lib

    cuda_lib.bind(lib)
    try:
        yield
    finally:
        cuda_lib.bind(cuda_lib.library())


def ms_in_turns(fn, other, reps=10, setup=None):
    """Times of ``fn`` launched from the other library, the package's, the
    package's, the other; each as (ms, ms with the launch queued).  Returns
    ([other, other], [own, own])."""
    both = lambda: (cuda_ms(fn, reps, setup=setup), cuda_ms(fn, reps, queued=True, setup=setup))
    with using_library(other):
        o1 = both()
    n1, n2 = both(), both()
    with using_library(other):
        o2 = both()
    return [o1, o2], [n1, n2]


def turns_line(other, own) -> str:
    f = lambda t: f"{t[0]:.4f} ({t[1]:.4f})"
    return (f"other {f(other[0])} own {f(own[0])} own {f(own[1])} other {f(other[1])} ms "
            "(in brackets: with the launch queued behind a device-side spin)")


def bound(n_bytes: float, op_seconds: float = 0.0) -> dict:
    """The least time the card could take: bytes over the memory rate or the
    operations' time at their peak rate, whichever is larger."""
    byte_s = n_bytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(byte_s, op_seconds),
            "bound_by": "bytes" if byte_s >= op_seconds else "operations"}


def phd_op_seconds(terms: int) -> float:
    """Time of ``terms`` PHD terms (one expf each) at the peak rates."""
    return max(terms / SFU_OPS_PER_S, terms * PHD_FLOPS_PER_TERM / F32_FLOPS_PER_S)


def window_counts(flags, R: int):
    """Per pixel, how many pixels of its (2R+1)^2 window have ``flags`` set
    (outside the image counts as unset); f64[H, W]."""
    import torch

    c = torch.nn.functional.pad(flags.double(), (R + 1, R, R + 1, R)).cumsum(0).cumsum(1)
    side = 2 * R + 1
    return c[side:, side:] - c[:-side, side:] - c[side:, :-side] + c[:-side, :-side]


def max_err(a, b):
    """(max abs error, max rel error) of float tensors, NaNs must coincide."""
    import torch

    a, b = a.double(), b.double()
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise AssertionError("NaN positions differ")
    fin = ~torch.isnan(a)
    d = (a[fin] - b[fin]).abs()
    rel = d / b[fin].abs().clamp_min(1e-30)
    return float(d.max()) if d.numel() else 0.0, float(rel.max()) if d.numel() else 0.0


def assert_close(name, got, want):
    import torch

    ok = torch.isclose(got.double(), want.double(), rtol=RTOL, atol=ATOL, equal_nan=True)
    if not bool(ok.all()):
        bad = int((~ok).sum())
        raise AssertionError(f"{name}: {bad} elements outside rtol {RTOL} / atol {ATOL}")


def assert_equal(name, got, want):
    import torch

    if not torch.equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} elements differ")


# ---------------------------------------------------------------------------
# Phase 2: kernels vs their plain versions at VKITTI2 and ZED2 shapes
# ---------------------------------------------------------------------------


def phd_inputs(cfg, seed=0, fill=0.12, rows=None):
    """Front-filled pixel table + observation cloud (the generator of
    tests/test_phd_pallas.py at full size): slot s of a pixel is occupied
    only if slot s-1 is, so high slot planes are mostly empty.  ``rows``
    sets the table's rows in place of the image height (a rank's row slab
    with its halo)."""
    import torch
    from semantic_dsp_map_tpu_torch.ops.phd import PixelTable
    from semantic_dsp_map_tpu_torch.ops.projection import LabeledCloud

    rng = np.random.RandomState(seed)
    H, W, S = rows or cfg.height, cfg.width, cfg.phd_pixel_table_slots
    occ = np.arange(S)[:, None, None] < rng.poisson(fill * S, (1, H, W))
    track = rng.randint(0, 5, (S, H, W)).astype(np.int32)
    forget = rng.randint(0, 6, (S, H, W)).astype(np.int32)
    meta = np.where(occ, (track << 8) | forget, -1).astype(np.int32)
    dev = torch.device("cuda")
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    t = PixelTable(
        px=T(np.where(occ, rng.randn(S, H, W), 0).astype(np.float32)),
        py=T(np.where(occ, rng.randn(S, H, W), 0).astype(np.float32)),
        pz=T(np.where(occ, rng.rand(S, H, W) * 4 + 1, 0).astype(np.float32)),
        weight=T(np.where(occ, rng.rand(S, H, W), 0).astype(np.float32)),
        meta=T(meta),
        dropped=torch.zeros((), dtype=torch.int64, device=dev),
    )
    cloud = LabeledCloud(
        pos=T((rng.randn(H, W, 3) + np.array([0, 0, 2.5])).astype(np.float32)),
        sigma=T((0.2 + rng.rand(H, W) * 0.2).astype(np.float32)),
        label=T(rng.randint(0, 10, (H, W)).astype(np.int32)),
        track=T(rng.randint(0, 5, (H, W)).astype(np.int32)),
        valid=T(rng.rand(H, W) < 0.85),
    )
    return t, cloud, float(occ.mean())


def pass_b_inputs(cfg, params, t, cloud, ck_kappa):
    """The arguments ops.phd._pass_b hands to pass B for this table, cloud
    and ck_kappa (those of pass_b_raw and pass_b_cuda)."""
    import torch
    from semantic_dsp_map_tpu_torch.ops import phd

    occupied = t.meta >= 0
    trk_eff = torch.where(occupied, t.meta >> 8, -2)
    ff = phd.forgetting_factor(t.meta & 0xFF, params.forgetting_rate, params.max_forget_count)
    ff_eff = occupied.float() if params.if_use_independent_filter else torch.where(occupied, ff, 0.0)
    isg = 1.0 / torch.clamp(cloud.sigma, min=1e-6)
    ox, oy, oz = (cloud.pos[..., i].contiguous() for i in range(3))
    return (cfg, params, t.px, t.py, t.pz, trk_eff, ff_eff, isg, ox, oy, oz,
            cloud.valid, cloud.track, ck_kappa)


def pass_a_inputs(cfg, params, t, cloud, weff):
    """The arguments of pass A (those of pass_a_raw and pass_a_cuda) for this
    table and cloud with the weight plane ``weff``."""
    import torch

    isg = 1.0 / torch.clamp(cloud.sigma, min=1e-6)
    ox, oy, oz = (cloud.pos[..., i].contiguous() for i in range(3))
    return (cfg, params, t.px, t.py, t.pz, weff, t.meta >> 8, ox, oy, oz, isg, cloud.track)


def check_pass_a(tag, args):
    """Pass A's kernel against the plain version on ``args``, within the
    tolerance (the kernel adds a pixel's terms one by one in list order, the
    plain version the slots of one offset first), and two launches on the
    same input against each other, bit for bit.  Returns (ck, (max abs, max
    rel) error)."""
    import torch
    from semantic_dsp_map_tpu_torch.ops import phd, phd_cuda

    ck_p = phd.pass_a_raw(*args)
    ck_k = phd_cuda.pass_a_cuda(*args)
    ck_again = phd_cuda.pass_a_cuda(*args)
    torch.cuda.synchronize()
    assert_close(f"pass A ck {tag}", ck_k, ck_p)
    assert_equal(f"pass A ck {tag}, second launch", ck_again.view(torch.int32), ck_k.view(torch.int32))
    return ck_k, max_err(ck_k, ck_p)


#: Pass A's tile in csrc/phd.cu: a warp is 32 neighbouring pixels of one row.
PASS_A_WARP = 32


def pass_a_census(args):
    """From pass A's arguments: live entries (w_eff != 0), terms (one per live
    entry and pixel of the image within R of it), and the lane-iterations the
    kernel's walk spends on them: a warp of 32 neighbouring pixels of a row
    steps through one halo row as often as its longest lane has entries in
    its 2R+1 columns.  share = terms / lane-iterations."""
    import torch

    cfg, weff = args[0], args[5]
    R = cfg.neighbor_half
    S, H, W = weff.shape
    live = (weff != 0).sum(0).double()
    inside = torch.ones((H, W), dtype=torch.bool, device=weff.device)
    terms = int((live * window_counts(inside, R)).sum())
    # entries in columns x-R .. x+R of row r, for every pixel column x
    c = torch.nn.functional.pad(live, (R + 1, R)).cumsum(1)
    row_len = c[:, 2 * R + 1 :] - c[:, : -(2 * R + 1)]
    pad = -W % PASS_A_WARP
    longest = torch.nn.functional.pad(row_len, (0, pad)).view(H, -1, PASS_A_WARP).amax(2)
    # a halo row r serves the image rows within R of it
    rows = torch.arange(H, device=weff.device)
    served = (torch.clamp(rows + R, max=H - 1) - torch.clamp(rows - R, min=0) + 1).double()
    lane_iterations = int((longest * served[:, None]).sum()) * PASS_A_WARP
    return {"live_entries": int(live.sum()), "terms": terms, "lane_iterations": lane_iterations,
            "term_share": terms / max(lane_iterations, 1)}


def pass_a_bound(args, ck, census):
    """(bound dict, needed bytes, bound with every entry read whole) of pass
    A: w_eff of every entry, position and track (16 B) only of the live ones,
    the five observation planes, ck written once."""
    _, _, px, py, pz, weff, trk, ox, oy, oz, isg, otrk = args
    ops = phd_op_seconds(census["terms"])
    n = nbytes(weff, ox, oy, oz, isg, otrk, ck) + 16 * census["live_entries"]
    return bound(n, ops), n, bound(nbytes(px, py, pz, weff, trk, ox, oy, oz, isg, otrk, ck), ops)


def window_census(args):
    """From pass B's arguments, by the plain version's arithmetic: (bool[S, H,
    W] of entries with a valid same-track neighbour whose COEF^3 * exp(...)
    lies within 1e-6 of the 0.1 "rightly updated" threshold, where float
    rounding may decide the flag either way; shares of the terms that are
    exactly zero, denormal, and that give a denormal quotient: the ones the
    hardware's division takes its slow path for)."""
    import torch
    from semantic_dsp_map_tpu_torch.config import MIN_RIGHTLY_UPDATED_PDF
    from semantic_dsp_map_tpu_torch.ops.phd import _COEF3, _pad_hw

    cfg, params, px, py, pz, trk, ff, isg, ox, oy, oz, valid, otrk, ck = args
    S, H, W = px.shape
    R = cfg.neighbor_half
    occupied = trk != -2
    isg = isg[None]
    pads = [_pad_hw(o, R, 0.0) for o in (ox, oy, oz)]
    pv, pt, pck = _pad_hw(valid, R, False), _pad_hw(otrk, R, -1), _pad_hw(ck, R, 1.0)
    near = torch.zeros((S, H, W), dtype=torch.bool, device=px.device)
    counts = torch.zeros(4, dtype=torch.int64, device=px.device)  # terms, zero, denormal, quotient
    tiny = torch.finfo(torch.float32).tiny
    for dm in range(2 * R + 1):
        for dn in range(2 * R + 1):
            win = lambda a: a[dm : dm + H, dn : dn + W][None]
            zx = (px - win(pads[0])) * isg
            zy = (py - win(pads[1])) * isg
            zz = (pz - win(pads[2])) * isg
            g = _COEF3 * torch.exp(-0.5 * (zx * zx + zy * zy + zz * zz))
            term = occupied & win(pv)
            same = win(pt) == trk
            near |= term & same & ((g - MIN_RIGHTLY_UPDATED_PDF).abs() < 1e-6)
            gk = torch.where(same, g, g * params.id_transition_probability) * ff
            q = gk / win(pck)
            counts += torch.stack([term.sum(), (term & (gk == 0)).sum(),
                                   (term & (gk > 0) & (gk < tiny)).sum(),
                                   (term & (q > 0) & (q < tiny)).sum()])
    n, zero, denormal, quotient = counts.tolist()
    shares = {"terms": n, "zero": zero / max(n, 1), "denormal": denormal / max(n, 1),
              "denormal_quotient": quotient / max(n, 1)}
    return near, shares


def check_pass_b(tag, args):
    """Pass B's kernel against the plain version on ``args``: acc within the
    tolerance, flags equal away from the threshold.  Returns (kernel's acc
    and right, (max abs, max rel) error, entries near the threshold)."""
    import torch
    from semantic_dsp_map_tpu_torch.ops import phd, phd_cuda

    acc_p, right_p = phd.pass_b_raw(*args)
    acc_k, right_k = phd_cuda.pass_b_cuda(*args)
    torch.cuda.synchronize()
    assert_close(f"pass B acc {tag}", acc_k, acc_p)
    n_near = 0
    if not args[1].if_use_independent_filter:
        near, shares = window_census(args)
        n_near = int(near.sum())
        print(f"[phd] {tag}: of {shares['terms']} terms {shares['zero']:.5f} are zero, "
              f"{shares['denormal']:.5f} denormal, {shares['denormal_quotient']:.5f} give a "
              "denormal quotient")
        differ = right_k != right_p
        if bool((differ & ~near).any()):
            raise AssertionError(
                f"pass B right {tag}: {int((differ & ~near).sum())} flags differ "
                "away from the threshold"
            )
        print(f"[phd] {tag}: right flags differing {int(differ.sum())}, "
              f"entries within 1e-6 of the threshold {n_near}")
    else:
        assert_equal(f"pass B right {tag}", right_k, right_p)
    return acc_k, right_k, max_err(acc_k, acc_p), n_near


def pass_b_bound(args, acc, right):
    """(bound dict, bytes, terms) of pass B on ``args``: one term per occupied
    entry and valid observation pixel of its window; every input read once,
    every output written once."""
    cfg, _, px, py, pz, trk_eff, ff_eff, isg, ox, oy, oz, valid, otrk, ck = args
    terms = int(((trk_eff != -2).sum(0).double() * window_counts(valid, cfg.neighbor_half)).sum())
    n = nbytes(px, py, pz, trk_eff, ff_eff, isg, ox, oy, oz, valid, otrk, ck, acc, right)
    return bound(n, phd_op_seconds(terms)), n, terms


def check_phd(cfg, report, prefix=""):
    """Passes A and B against the plain stencils; the numbers go into
    ``report`` under ``prefix`` + max_abs_err / ms / plain_ms."""
    import torch
    from semantic_dsp_map_tpu_torch.config import FilterParams
    from semantic_dsp_map_tpu_torch.ops import phd, phd_cuda

    t, cloud, fill = phd_inputs(cfg)
    S, H, W = t.px.shape
    print(f"[phd] {prefix}table S={S} H={H} W={W} R={cfg.neighbor_half}, occupied share {fill:.4f}")
    for independent in (False, True):
        params = FilterParams(
            detection_probability=0.9, noise_number=0.1,
            if_use_independent_filter=independent, if_consider_depth_noise=True,
        )
        tag = f"{prefix}independent={independent}"
        ck_plain = phd.stencil_pass_a(cfg, params, t, cloud)
        ck_kern = phd.stencil_pass_a_any(cfg, params, t, cloud)
        torch.cuda.synchronize()
        assert_close(f"pass A ck_kappa {tag}", ck_kern, ck_plain)
        # the kernel alone, on the weight plane it has been timed on since its
        # first version (no forgetting factor: every occupied entry is live)
        occupied = t.meta >= 0
        a_args = pass_a_inputs(cfg, params, t, cloud, torch.where(occupied, t.weight, 0.0))
        ck_raw, (a_abs, a_rel) = check_pass_a(tag, a_args)

        # pass B on identical inputs (the plain pass A's ck_kappa)
        args = pass_b_inputs(cfg, params, t, cloud, ck_plain)
        acc_k, right_k, (b_abs, b_rel), n_near = check_pass_b(tag, args)
        nw_p, nf_p = phd.stencil_pass_b(cfg, params, t, cloud, ck_plain)
        nw_k, nf_k = phd.stencil_pass_b_any(cfg, params, t, cloud, ck_plain)
        assert_close(f"new weight {tag}", nw_k, nw_p)
        if n_near == 0:
            assert_equal(f"new forget {tag}", nf_k, nf_p)

        # Pass A alone (arguments made once); until this version its row held
        # the two elementwise ops that make its weight and track planes too:
        # that figure is kept beside it for one more round.
        run_a, run_b = lambda: phd_cuda.pass_a_cuda(*a_args), lambda: phd_cuda.pass_b_cuda(*args)
        prep_a = lambda: phd_cuda.pass_a_cuda(
            *a_args[:5], torch.where(occupied, t.weight, 0.0), t.meta >> 8, *a_args[7:])
        ms_a, q_a = cuda_ms(run_a, 10), cuda_ms(run_a, 10, queued=True)
        ms_a_prep, q_a_prep = cuda_ms(prep_a, 10), cuda_ms(prep_a, 10, queued=True)
        ms_a_plain = cuda_ms(lambda: phd.pass_a_raw(*a_args), 3)
        ms_b, q_b = cuda_ms(run_b, 10), cuda_ms(run_b, 10, queued=True)
        ms_b_plain = cuda_ms(lambda: phd.pass_b_raw(*args), 3)
        print(f"[phd] {tag}: pass A max abs {a_abs:.3e} rel {a_rel:.3e}, "
              f"kernel {ms_a:.3f} ms ({q_a:.3f} with the launch queued; with the two ops that make "
              f"its planes {ms_a_prep:.3f}, {q_a_prep:.3f}), plain {ms_a_plain:.3f} ms")
        print(f"[phd] {tag}: pass B max abs {b_abs:.3e} rel {b_rel:.3e}, "
              f"kernel {ms_b:.3f} ms ({q_b:.3f} with the launch queued), plain {ms_b_plain:.3f} ms")
        if not independent:
            # Bounds from these inputs (pass_a_bound, pass_b_bound).
            census = pass_a_census(a_args)
            bound_a, bytes_a, bound_a_all = pass_a_bound(a_args, ck_raw, census)
            terms_a = census["terms"]
            in_a = a_args[2:]
            bound_b, bytes_b, terms_b = pass_b_bound(args, acc_k, right_k)
            note_a = cache_note(report["phd_pass_a"], prefix, *in_a)
            note_b = cache_note(report["phd_pass_b"], prefix, *args[2:])
            print(f"[phd] {prefix}pass A walk: {census['live_entries']} live entries, {terms_a} terms in "
                  f"{census['lane_iterations']} lane-iterations: {census['term_share']:.4f} of them are terms")
            print(f"[phd] {prefix}bounds: pass A {bytes_a} bytes, {terms_a} terms -> "
                  f"{bound_a['bound_ms']:.4f} ms by {bound_a['bound_by']} (every entry read whole: "
                  f"{bound_a_all['bound_ms']:.4f} ms){note_a}; pass B "
                  f"{bytes_b} bytes, {terms_b} terms -> {bound_b['bound_ms']:.4f} ms by "
                  f"{bound_b['bound_by']}{note_b}")
            report["phd_pass_a"].update(
                {prefix + "max_abs_err": a_abs, prefix + "ms": ms_a, prefix + "queued_ms": q_a,
                 prefix + "with_prep_ms": ms_a_prep, prefix + "with_prep_queued_ms": q_a_prep,
                 prefix + "plain_ms": ms_a_plain, prefix + "term_share": census["term_share"],
                 **{prefix + k: v for k, v in bound_a.items()}})
            report["phd_pass_b"].update(
                {prefix + "max_abs_err": b_abs, prefix + "ms": ms_b, prefix + "queued_ms": q_b,
                 prefix + "plain_ms": ms_b_plain,
                 **{prefix + k: v for k, v in bound_b.items()}})


def random_render_state(cfg, seed=5):
    """A seeded full-size particle store with mixed status, stamps and
    tracks (the generator of tests/test_render_pallas.py at full size)."""
    import torch
    from semantic_dsp_map_tpu_torch.state import Particles

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    V, K = cfg.num_voxels, cfg.slots_per_voxel
    n = V * K
    u = torch.rand(n, generator=g, device=dev)
    # status probabilities 0.3 INVALID, 0.4 UPDATED, 0.2 REGULAR_BORN, 0.1 GUESSED
    status = ((u >= 0.3).int() + (u >= 0.7).int() + (u >= 0.9).int()).to(torch.uint8)
    weight = torch.rand(n, generator=g, device=dev) * 1.4
    weight[: n // 8] *= 0.05  # hit the GC path
    ri = lambda hi, m: torch.randint(0, hi, (m,), generator=g, device=dev, dtype=torch.int32)
    p = Particles(
        px=torch.zeros(n, device=dev), py=torch.zeros(n, device=dev),
        pz=torch.zeros(n, device=dev), weight=weight,
        label=ri(8, n).to(torch.uint8), track=ri(4, n),
        status=status, forget=torch.zeros(n, dtype=torch.uint8, device=dev),
        stamp=ri(3, n),
    )
    return p, ri(3, V), ri(2, V)


#: A block's span of voxels in csrc/render.cu at K <= 7 and its sub-spans.
RENDER_SPAN, RENDER_SUB = 1024, 256


def check_render_once(tag, cfg, p, vst, vax, thr):
    """The render kernel on a copy of the store ``p`` against the plain
    version: occ, label, track and the new status equal, the sums within the
    tolerance.  Returns (kernel's store and result, (weight_sum, new weight)
    max abs errors, whether both are also equal bit for bit)."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch.ops.render import render_core_plain
    from semantic_dsp_map_tpu_torch.ops.render_cuda import render_core_cuda

    new_p, r_p = render_core_plain(cfg, p, vst, vax, thr)
    pk = dataclasses.replace(p, weight=p.weight.clone(), status=p.status.clone())
    pk, r_k = render_core_cuda(cfg, pk, vst, vax, thr)
    torch.cuda.synchronize()
    for name in ("occ", "label", "track"):
        assert_equal(f"render {tag} {name}", getattr(r_k, name), getattr(r_p, name))
    assert_equal(f"render {tag} new status", pk.status, new_p.status)
    assert_close(f"render {tag} weight_sum", r_k.weight_sum, r_p.weight_sum)
    assert_close(f"render {tag} new weight", pk.weight, new_p.weight)
    bits = (torch.equal(r_k.weight_sum.view(torch.int32), r_p.weight_sum.view(torch.int32))
            and torch.equal(pk.weight.view(torch.int32), new_p.weight.view(torch.int32)))
    return pk, r_k, (max_err(r_k.weight_sum, r_p.weight_sum)[0], max_err(pk.weight, new_p.weight)[0]), bits


def render_census(cfg, p, pk, vax, vst, r):
    """Counts of the store ``p`` before and ``pk`` after the render, and its
    bound: the status of every slot (1 B), the stamp (4 B) only of the slots
    with a status set, weight, track and label (9 B) only of the alive ones,
    both voxel stamps and the four results; written back only the weights the
    clamp changed and the statuses collected.  ``bound_all``: every slot read
    whole, weight and status of all written back."""
    import torch

    K = cfg.slots_per_voxel
    has_status = p.status != 0
    alive = has_status & (p.stamp >= vax.repeat_interleave(K))
    pad = lambda a, m: torch.nn.functional.pad(a, (0, -a.numel() % m))
    spans = pad(has_status, RENDER_SPAN * K).view(-1, RENDER_SPAN * K).any(1)
    subs = pad(alive, RENDER_SUB * K).view(-1, RENDER_SUB * K).any(1)
    c = {"slots": p.status.numel(), "with_status": int(has_status.sum()), "alive": int(alive.sum()),
         "clamped": int((pk.weight != p.weight).sum()), "collected": int((pk.status != p.status).sum()),
         "spans": spans.numel(), "spans_without_status": int((~spans).sum()),
         "sub_spans": subs.numel(), "sub_spans_without_alive": int((~subs).sum())}
    fixed = nbytes(p.status, vax, vst, r.occ, r.label, r.track, r.weight_sum)
    c["bound"] = bound(fixed + 4 * c["with_status"] + 9 * c["alive"] + 4 * c["clamped"] + c["collected"])
    c["bound_every_stamp"] = bound(fixed + nbytes(p.stamp) + 9 * c["alive"] + 4 * c["clamped"]
                                   + c["collected"])["bound_ms"]
    c["bound_all"] = bound(nbytes(p.weight, p.stamp, p.status, p.track, p.label, vax, vst,
                                  pk.weight, pk.status, r.occ, r.label, r.track, r.weight_sum))["bound_ms"]
    return c


def census_line(c) -> str:
    return (f"{c['with_status']} of {c['slots']} slots with a status, {c['alive']} alive, {c['clamped']} "
            f"weights clamped, {c['collected']} slots collected; {c['spans_without_status']} of "
            f"{c['spans']} spans of {RENDER_SPAN} voxels without a status, {c['sub_spans_without_alive']} "
            f"of {c['sub_spans']} sub-spans of {RENDER_SUB} without a live slot; bound "
            f"{c['bound']['bound_ms']:.4f} ms by {c['bound']['bound_by']} (every slot's stamp read: "
            f"{c['bound_every_stamp']:.4f} ms; every slot read whole, weight and status of all "
            f"written back: {c['bound_all']:.4f} ms)")


def render_runner(cfg, p, vst, vax, thr):
    """(run, restore) for timing the render on the store ``p``: the kernel
    works in place, so ``restore`` gives a scratch copy its weight and status
    back before each timed launch (outside the events)."""
    import dataclasses

    from semantic_dsp_map_tpu_torch.ops.render_cuda import render_core_cuda

    scratch = dataclasses.replace(p, weight=p.weight.clone(), status=p.status.clone())

    def restore():
        scratch.weight.copy_(p.weight)
        scratch.status.copy_(p.status)

    return (lambda: render_core_cuda(cfg, scratch, vst, vax, thr)), restore


def check_render(cfg, report, prefix=""):
    import torch
    from semantic_dsp_map_tpu_torch.ops.render import render_core_plain

    p, vst, vax = random_render_state(cfg)
    thr = 0.4
    pk, r_k, (e1, e2), bits = check_render_once(prefix + "checked store", cfg, p, vst, vax, thr)
    run, restore = render_runner(cfg, p, vst, vax, thr)
    ms, q_ms = cuda_ms(run, 10, setup=restore), cuda_ms(run, 10, queued=True, setup=restore)
    ms_plain = cuda_ms(lambda: render_core_plain(cfg, p, vst, vax, thr), 3)
    occ = torch.bincount((r_k.occ + 1).long(), minlength=4).tolist()
    print(f"[render] {prefix}V={cfg.num_voxels} K={cfg.slots_per_voxel}: occ histogram "
          f"(-1,0,1,2) {occ}; weight_sum max abs {e1:.3e}, new weight max abs {e2:.3e} (both "
          f"bit-equal: {bits}); kernel {ms:.3f} ms ({q_ms:.3f} with the launch queued; each launch on "
          f"the store as it was before the render), plain {ms_plain:.3f} ms")
    c = render_census(cfg, p, pk, vax, vst, r_k)
    note = cache_note(report["render"], prefix, p.weight, p.stamp, p.status, p.track, p.label,
                      vax, vst)
    print(f"[render] {prefix}{census_line(c)}{note}")
    report["render"].update({prefix + "max_abs_err": max(e1, e2), prefix + "ms": ms,
                             prefix + "queued_ms": q_ms, prefix + "plain_ms": ms_plain,
                             prefix + "sums_bit_equal": bits,
                             **{prefix + k: v for k, v in c["bound"].items()}})


def observe_inputs(cfg):
    """A seeded full-size store (mixed status, stamps and tracks) whose
    positions fill the map volume around a rotated camera, so a real share
    of slots lies in the frustum.  Returns (the candidate scan's arguments,
    the store, the per-voxel scroll stamps)."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch.ops import codecs
    from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices
    from semantic_dsp_map_tpu_torch.state import init_scroll

    dev = torch.device("cuda")
    p, _, _ = random_render_state(cfg, seed=7)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    n = cfg.num_voxels * cfg.slots_per_voxel
    hx, hy, hz = cfg.map_half_extent
    u = lambda h: (torch.rand(n, generator=g, device=dev) * 2 - 1) * h
    px, py, pz = u(hx), u(hy), u(hz)
    # a scrolled map: per-axis stamps 0-1 against slot stamps 0-2
    ri = lambda m: torch.randint(0, 2, (m,), generator=g, device=dev, dtype=torch.int32)
    scroll = dataclasses.replace(init_scroll(cfg, dev), axis_stamp_x=ri(cfg.nx),
                                 axis_stamp_y=ri(cfg.ny))
    vax = codecs.axis_stamps_per_voxel(cfg, scroll)
    # 20 degrees of yaw and 5 of pitch, off the origin
    quat = torch.tensor([0.9833, 0.0428, 0.1737, 0.0076], device=dev)
    quat = quat / quat.norm()
    _, _, r_cw, t_cw = camera_matrices(torch.tensor([0.3, -0.2, 0.5], device=dev), quat)
    return (cfg, px, py, pz, p.status, p.stamp, vax, r_cw, t_cw), p, vax


def front_bound(args, ha, hc):
    """(bound dict, alive slots, [bound with every slot's stamp read, bound
    with every slot's stamp and position read]) of the candidate scan on
    ``args``: the status of every slot (1 B), the voxel stamps, the pose and
    the outputs; the stamp (4 B) only of the slots with a status set and
    the positions (12 B) only of the alive ones, since an empty slot's
    stamp and a dead slot's position decide nothing."""
    cfg, px, py, pz, status, stamp, vax, r_cw, t_cw = args
    has_status = status != 0
    alive = has_status & (stamp >= vax.repeat_interleave(cfg.slots_per_voxel))
    n_alive = int(alive.sum())
    fixed = nbytes(status, vax, r_cw, t_cw, ha, hc)
    b = bound(fixed + 4 * int(has_status.sum()) + 12 * n_alive)
    looser = [bound(fixed + nbytes(stamp) + 12 * n_alive)["bound_ms"],
              bound(nbytes(px, py, pz, status, stamp, vax, ha, hc))["bound_ms"]]
    return b, n_alive, looser


def check_observe(cfg, report, prefix=""):
    """The observe candidate scan and the movable-voxel scan against their
    plain versions, byte for byte, on the store of observe_inputs."""
    import torch
    from semantic_dsp_map_tpu_torch.ops.observe import front_candidates_plain, movable_voxels_plain
    from semantic_dsp_map_tpu_torch.ops.observe_cuda import (
        front_candidates_cuda, movable_voxels_cuda,
    )

    args, p, vax = observe_inputs(cfg)
    V, K = cfg.num_voxels, cfg.slots_per_voxel
    n = V * K
    ha_p, hc_p = front_candidates_plain(*args)
    ha_k, hc_k = front_candidates_cuda(*args)
    torch.cuda.synchronize()
    assert_equal(f"{prefix}front has_alive", ha_k, ha_p)
    assert_equal(f"{prefix}front has_cand", hc_k, hc_p)
    alive_share = float(ha_p.float().mean())
    cand_share = float(hc_p.float().mean())
    if not 0.0 < cand_share < alive_share < 1.0:
        raise AssertionError(f"{prefix}front: degenerate store (alive {alive_share}, cand {cand_share})")
    run_f = lambda: front_candidates_cuda(*args)
    ms_f, q_f = cuda_ms(run_f, 10), cuda_ms(run_f, 10, queued=True)
    ms_f_plain = cuda_ms(lambda: front_candidates_plain(*args), 3)

    max_movable = 1
    margs = (cfg, p.track, p.status, p.stamp, vax, max_movable)
    hm_p = movable_voxels_plain(*margs)
    hm_k = movable_voxels_cuda(*margs)
    torch.cuda.synchronize()
    assert_equal(f"{prefix}movable", hm_k, hm_p)
    mov_share = float(hm_p.float().mean())
    if not 0.0 < mov_share < 1.0:
        raise AssertionError(f"{prefix}movable: degenerate store (share {mov_share})")
    run_m = lambda: movable_voxels_cuda(*margs)
    ms_m, q_m = cuda_ms(run_m, 10), cuda_ms(run_m, 10, queued=True)
    ms_m_plain = cuda_ms(lambda: movable_voxels_plain(*margs), 3)
    # The movable scan inside a graph on this store, the one its bound and
    # its earlier times are reckoned on ([graph] times it on a real frame's
    # store, which has fewer slots with a status).
    g_m = graph_ms(run_m)
    print(f"[observe] {prefix}V={V} K={K}: voxel shares alive {alive_share:.4f}, "
          f"candidate {cand_share:.4f}, movable {mov_share:.4f}; outputs byte-equal; "
          f"front kernel {ms_f:.4f} ms ({q_f:.4f} with the launch queued), plain "
          f"{ms_f_plain:.3f} ms; movable kernel {ms_m:.4f} ms "
          f"({q_m:.4f} queued, {g_m:.4f} inside a graph), plain {ms_m_plain:.3f} ms")
    # Bounds from this store (front_bound); the movable scan as reckoned
    # since it was written: status and stamp of every slot, the track (4 B)
    # of the alive slots.
    b_f, n_alive, (b_f_stamps, b_f_all) = front_bound(args, ha_k, hc_k)
    b_m = bound(nbytes(p.status, p.stamp, vax, hm_k) + 4 * n_alive)
    note_f = cache_note(report["front_candidates"], prefix, *args[1:])
    note_m = cache_note(report["movable_voxels"], prefix, p.track, p.status, p.stamp, vax)
    print(f"[observe] {prefix}{n_alive} of {n} slots alive; bounds: front "
          f"{b_f['bound_ms']:.4f} ms (every slot's stamp read: {b_f_stamps:.4f} ms; all {n} "
          f"slots' positions too: {b_f_all:.4f} ms){note_f}, "
          f"movable {b_m['bound_ms']:.4f} ms (all tracks read: "
          f"{bound(nbytes(p.track, p.status, p.stamp, vax, hm_k))['bound_ms']:.4f} ms){note_m}, by bytes")
    report["front_candidates"].update(
        {prefix + "max_abs_err": 0.0, prefix + "ms": ms_f, prefix + "queued_ms": q_f,
         prefix + "plain_ms": ms_f_plain,
         **{prefix + k: v for k, v in b_f.items()}})
    report["movable_voxels"].update(
        {prefix + "max_abs_err": 0.0, prefix + "ms": ms_m, prefix + "queued_ms": q_m,
         prefix + "plain_ms": ms_m_plain, prefix + "in_graph_ms": g_m,
         **{prefix + k: v for k, v in b_m.items()}})


def compare_render(other, tag, cfg, p, vst, vax, thr, card):
    """The render from the package's library and from ``other`` on the store
    ``p``, each on its own copy: integers and statuses equal, sums within the
    tolerance; then timed in turns.  Returns the times."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch.ops.render_cuda import render_core_cuda

    copy = lambda: dataclasses.replace(p, weight=p.weight.clone(), status=p.status.clone())
    p_n, r_n = render_core_cuda(cfg, copy(), vst, vax, thr)
    with using_library(other):
        p_o, r_o = render_core_cuda(cfg, copy(), vst, vax, thr)
    torch.cuda.synchronize()
    for name in ("occ", "label", "track"):
        assert_equal(f"{tag} render {name}, other version", getattr(r_o, name), getattr(r_n, name))
    assert_equal(f"{tag} render status, other version", p_o.status, p_n.status)
    assert_close(f"{tag} render weight_sum, other version", r_o.weight_sum, r_n.weight_sum)
    assert_close(f"{tag} render weight, other version", p_o.weight, p_n.weight)
    same_bits = (torch.equal(r_o.weight_sum.view(torch.int32), r_n.weight_sum.view(torch.int32))
                 and torch.equal(p_o.weight.view(torch.int32), p_n.weight.view(torch.int32)))
    del p_n, p_o, r_n, r_o
    run, restore = render_runner(cfg, p, vst, vax, thr)
    r_other, r_own = ms_in_turns(run, other, setup=restore)
    print(f"[against] {tag} render: {turns_line(r_other, r_own)}; occ, label, track, status equal, "
          f"sums bit-equal: {same_bits} ({card})")
    return {"other_ms": r_other, "own_ms": r_own}


def compare_pass_a(other, tag, args, card):
    """Pass A from the package's library and from ``other`` on ``args``: ck
    within the tolerance of each other, then timed in turns."""
    import torch
    from semantic_dsp_map_tpu_torch.ops import phd_cuda

    ck_n = phd_cuda.pass_a_cuda(*args)
    with using_library(other):
        ck_o = phd_cuda.pass_a_cuda(*args)
    torch.cuda.synchronize()
    assert_close(f"{tag} pass A ck, other version", ck_o, ck_n)
    a_other, a_own = ms_in_turns(lambda: phd_cuda.pass_a_cuda(*args), other)
    print(f"[against] {tag} pass A: {turns_line(a_other, a_own)}; ck within rtol {RTOL} / atol "
          f"{ATOL} of each other, max abs {max_err(ck_o, ck_n)[0]:.3e} ({card})")
    return {"other_ms": a_other, "own_ms": a_own}


def compare_versions(other, cfg, label, card):
    """Both PHD passes, the render and the candidate scan from the package's
    library and from ``other`` (a build of another version of the sources)
    on the inputs of check_phd, check_render and check_observe: the other's
    results must agree too, and the two are timed in turns (other, own, own,
    other).  Returns the times."""
    import torch
    from semantic_dsp_map_tpu_torch.config import FilterParams
    from semantic_dsp_map_tpu_torch.ops import phd, phd_cuda
    from semantic_dsp_map_tpu_torch.ops.observe_cuda import front_candidates_cuda

    params = FilterParams(detection_probability=0.9, noise_number=0.1,
                          if_consider_depth_noise=True)
    t, cloud, _ = phd_inputs(cfg)
    a_args = pass_a_inputs(cfg, params, t, cloud, torch.where(t.meta >= 0, t.weight, 0.0))
    a_times = compare_pass_a(other, label, a_args, card)
    del a_args
    args = pass_b_inputs(cfg, params, t, cloud, phd.stencil_pass_a(cfg, params, t, cloud))
    acc_n, right_n = phd_cuda.pass_b_cuda(*args)
    with using_library(other):
        acc_o, right_o = phd_cuda.pass_b_cuda(*args)
    torch.cuda.synchronize()
    assert_close(f"{label} pass B acc, other version", acc_o, acc_n)
    same_bits = torch.equal(acc_o.view(torch.int32), acc_n.view(torch.int32))
    assert_equal(f"{label} pass B right, other version", right_o, right_n)
    b_other, b_own = ms_in_turns(lambda: phd_cuda.pass_b_cuda(*args), other)
    print(f"[against] {label} pass B: {turns_line(b_other, b_own)}; acc bits equal: {same_bits}, "
          f"flags equal ({card})")
    del t, cloud, args, acc_n, acc_o

    p, vst, vax = random_render_state(cfg)
    r_times = compare_render(other, label, cfg, p, vst, vax, 0.4, card)
    del p, vst, vax

    fargs, _, _ = observe_inputs(cfg)
    got_n = front_candidates_cuda(*fargs)
    with using_library(other):
        got_o = front_candidates_cuda(*fargs)
    torch.cuda.synchronize()
    for name, o, n in zip(("has_alive", "has_cand"), got_o, got_n):
        assert_equal(f"{label} front {name}, other version", o, n)
    f_other, f_own = ms_in_turns(lambda: front_candidates_cuda(*fargs), other)
    print(f"[against] {label} front scan: {turns_line(f_other, f_own)}; bytes equal ({card})")
    return {"pass_a": a_times, "pass_b": {"other_ms": b_other, "own_ms": b_own},
            "render": r_times, "front_candidates": {"other_ms": f_other, "own_ms": f_own}}


def compare_gather(other, card, rounds=3):
    """The gather from the package's library and from ``other`` on the
    probe's inputs, with the indices as drawn and sorted: bytes equal to
    each other; then timed in turns (other, own, own, other; ``rounds``
    times), each a run of 50 launches, per launch.  Returns the times."""
    import torch
    from semantic_dsp_map_tpu_torch.benchmarks import prim_bench7
    from semantic_dsp_map_tpu_torch.ops.probes_cuda import gather_cuda
    from semantic_dsp_map_tpu_torch.timing import bench

    dev = torch.device("cuda")
    depth, rc = prim_bench7.make_inputs(dev)
    times = {}
    for tag, idx in (("random", rc), ("sorted", torch.sort(rc).values)):
        run = lambda: gather_cuda(depth, idx)
        own = run()
        with using_library(other):
            theirs = run()
        torch.cuda.synchronize()
        assert_equal(f"gather {tag}, other version", theirs.view(torch.int32), own.view(torch.int32))
        o, n = [], []
        for _ in range(rounds):
            with using_library(other):
                o.append(bench(run, dev, 50)["device_ms"])
            n += [bench(run, dev, 50)["device_ms"], bench(run, dev, 50)["device_ms"]]
            with using_library(other):
                o.append(bench(run, dev, 50)["device_ms"])
        times[tag] = {"other_ms": o, "own_ms": n}
        print(f"[against] gather, indices {tag}: per launch in runs of 50, in turns: other "
              f"{float(np.median(o)):.5f} ms ({spread(o)}), own {float(np.median(n)):.5f} ms "
              f"({spread(n)}); bytes equal ({card})")
    return times


#: Bytes the L2 moves to an SM for one 4 B table read: one sector.
L2_SECTOR_BYTES = 32
#: The gather's L1 line folds its indices into the table's first 16,384
#: entries: 64 KB, which the L1 of every SM holds.
L1_SPAN = 16384


def runs_in_turns(fns, reps, rounds=5):
    """Runs of ``reps`` launches of each of ``fns`` in turns (a, b, ..., a,
    b, ...), ``rounds`` times, each timed by ``timing.bench``.  Per fn:
    {device_ms, enqueue_ms} of every round, per launch."""
    import torch
    from semantic_dsp_map_tpu_torch.timing import bench

    dev = torch.device("cuda")
    out = [{"device_ms": [], "enqueue_ms": []} for _ in fns]
    for _ in range(rounds):
        for fn, o in zip(fns, out):
            r = bench(fn, dev, reps)
            o["device_ms"].append(r["device_ms"])
            o["enqueue_ms"].append(r["enqueue_ms"])
    return out


def spread(times) -> str:
    return f"{min(times):.5f}-{max(times):.5f}"


def check_probes(report):
    """The gather and x2 probe kernels against their plain versions on the
    card, byte for byte (both only move or double f32 values), at the
    probes' shapes; the gather also on the same lookups with the indices
    sorted (its table reads then coalesce: what is left is the streaming)
    and with them folded into the table's first 64 KB (which each SM's L1
    holds: random reads that the L2 does not serve).
    Timed in turns with the one PyTorch call that computes the same
    function, five rounds of runs of 50 (gather) or 200 (x2) launches each:
    the median per launch and the spread of the rounds; beside the plain
    version and, queued behind a device-side spin, one launch alone."""
    import torch
    from semantic_dsp_map_tpu_torch.benchmarks import prim_bench7
    from semantic_dsp_map_tpu_torch.ops.probes import gather_plain, scale2_plain
    from semantic_dsp_map_tpu_torch.ops.probes_cuda import gather_cuda, scale2_cuda
    from semantic_dsp_map_tpu_torch.timing import bench

    dev = torch.device("cuda")
    run_ms = lambda fn, reps=50: bench(fn, dev, reps)["device_ms"]
    # one launch queued behind a device-side spin: the device's time alone
    alone_ms = lambda fn: cuda_ms(fn, 20, queued=True)
    depth, rc = prim_bench7.make_inputs(dev)
    rc_sorted = torch.sort(rc).values
    rc_l1 = rc % L1_SPAN
    flat = depth.reshape(-1)
    for tag, idx in (("", rc), ("sorted ", rc_sorted), ("L1 span ", rc_l1)):
        got, want = gather_cuda(depth, idx), gather_plain(depth, idx)
        torch.cuda.synchronize()
        assert_equal(f"gather {tag}", got.view(torch.int32), want.view(torch.int32))
        assert_equal(f"gather {tag}vs index_select", got, torch.index_select(flat, 0, idx))
    kern, lib, kern_s, lib_s, kern_l1 = runs_in_turns(
        [lambda: gather_cuda(depth, rc), lambda: torch.index_select(flat, 0, rc),
         lambda: gather_cuda(depth, rc_sorted), lambda: torch.index_select(flat, 0, rc_sorted),
         lambda: gather_cuda(depth, rc_l1)], 50)
    med = lambda r: float(np.median(r["device_ms"]))
    n = rc.numel()
    entry = dict(max_abs_err=0.0, ms=med(kern), ms_rounds=kern["device_ms"],
                 plain_ms=run_ms(lambda: gather_plain(depth, rc)),
                 library_ms=med(lib), library_ms_rounds=lib["device_ms"],
                 sorted_ms=med(kern_s), sorted_ms_rounds=kern_s["device_ms"],
                 library_sorted_ms=med(lib_s), l1_span_ms=med(kern_l1),
                 queued_ms=alone_ms(lambda: gather_cuda(depth, rc)),
                 library_queued_ms=alone_ms(lambda: torch.index_select(flat, 0, rc)),
                 l2_sector_bytes=n * L2_SECTOR_BYTES, **bound(nbytes(depth, rc, got)))
    report["gather"].update(entry)
    print(f"[probes] gather {n} lookups from {tuple(depth.shape)} f32: bytes equal, with the "
          f"indices as drawn and sorted; per launch in runs of 50, five rounds in turns (median, "
          f"spread): kernel {entry['ms']:.5f} ms ({spread(kern['device_ms'])}), torch.index_select "
          f"{entry['library_ms']:.5f} ms ({spread(lib['device_ms'])}); sorted indices: kernel "
          f"{entry['sorted_ms']:.5f} ms ({spread(kern_s['device_ms'])}), torch.index_select "
          f"{entry['library_sorted_ms']:.5f} ms ({spread(lib_s['device_ms'])}); indices in the "
          f"table's first {L1_SPAN * 4 // 1024} KB: kernel {entry['l1_span_ms']:.5f} ms "
          f"({spread(kern_l1['device_ms'])}); plain (indexing) "
          f"{entry['plain_ms']:.5f} ms; one launch queued behind a spin: kernel "
          f"{entry['queued_ms']:.5f} ms, torch.index_select {entry['library_queued_ms']:.5f} ms; "
          f"bound {entry['bound_ms']:.5f} ms by {entry['bound_by']} (share "
          f"{entry['bound_ms'] / entry['ms']:.3f}, sorted {entry['bound_ms'] / entry['sorted_ms']:.3f})"
          f"{cache_note(report['gather'], '', depth, rc)}")
    print(f"[probes] gather L2 sector traffic (information, not the bound): {n} table reads x "
          f"{L2_SECTOR_BYTES} B = {entry['l2_sector_bytes']} B, "
          f"{entry['l2_sector_bytes'] / nbytes(depth, rc, got):.2f}x the bytes the bound counts")

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    x = torch.randn((8, 128), generator=g, device=dev)
    got, want = scale2_cuda(x), scale2_plain(x)
    torch.cuda.synchronize()
    assert_equal("scale2", got.view(torch.int32), want.view(torch.int32))
    small = torch.ones(8, device=dev)
    noop_ms = run_ms(lambda: small + 1.0, 200)
    kern, lib = runs_in_turns([lambda: scale2_cuda(x), lambda: torch.mul(x, 2.0)], 200)
    entry = dict(max_abs_err=0.0, ms=med(kern), ms_rounds=kern["device_ms"],
                 plain_ms=run_ms(lambda: scale2_plain(x), 200),
                 library_ms=med(lib), library_ms_rounds=lib["device_ms"],
                 run_enqueue_ms=float(np.median(kern["enqueue_ms"])),
                 library_enqueue_ms=float(np.median(lib["enqueue_ms"])),
                 queued_ms=alone_ms(lambda: scale2_cuda(x)),
                 library_queued_ms=alone_ms(lambda: torch.mul(x, 2.0)),
                 **bound(nbytes(x, got)))
    report["scale2"].update(entry)
    print(f"[probes] scale2 on {tuple(x.shape)} f32: bytes equal; per launch in runs of 200, five "
          f"rounds in turns (median, spread): kernel {entry['ms']:.5f} ms "
          f"({spread(kern['device_ms'])}), torch.mul {entry['library_ms']:.5f} ms "
          f"({spread(lib['device_ms'])}); the host's part of it (enqueue): kernel "
          f"{entry['run_enqueue_ms']:.5f} ms ({spread(kern['enqueue_ms'])}), torch.mul "
          f"{entry['library_enqueue_ms']:.5f} ms ({spread(lib['enqueue_ms'])}); plain "
          f"{entry['plain_ms']:.5f} ms, x + 1 on 8 floats {noop_ms:.5f} ms; one launch queued "
          f"behind a spin (the device's time alone): kernel {entry['queued_ms']:.5f} ms, torch.mul "
          f"{entry['library_queued_ms']:.5f} ms; bound {entry['bound_ms']:.7f} ms by {entry['bound_by']}")


def launch_cost(entry_name, call, reps=200, rounds=3):
    """Host time per launch of the kernel wrapper ``call`` in runs of
    ``reps`` (``timing.bench``'s enqueue_ms) and of the bare ctypes call of
    its C entry point ``entry_name`` with the arguments the wrapper passed it
    (no checks, no allocation), in turns, ``rounds`` times.  Returns (wrapper
    rounds, bare rounds)."""
    from semantic_dsp_map_tpu_torch.ops import cuda_lib

    real = getattr(cuda_lib.entry, entry_name)
    passed = []

    def record(*args):
        passed.append(args)
        return real(*args)

    setattr(cuda_lib.entry, entry_name, record)
    try:
        keep = call()  # its outputs stay alive: the bare calls write there
    finally:
        setattr(cuda_lib.entry, entry_name, real)
    args = passed[0]
    err = real(*args)
    if err:
        raise cuda_lib.error(err, entry_name)
    wrapper, bare = runs_in_turns([call, lambda: real(*args)], reps, rounds)
    del keep
    return wrapper["enqueue_ms"], bare["enqueue_ms"]


def check_launch(report, card):
    """[launch]: what a launch costs the host.  Each of the seven wrappers at
    its main shapes (the five frame kernels at VKITTI2 shapes on the inputs
    of phase 2, the probes at theirs): its host time per launch in runs of
    200, beside the bare ctypes call of the same entry point on the same
    pointers and beside torch.mul on [8, 128] f32.  The wrapper's own cost
    is the difference from the bare call."""
    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, virtual_kitti2_config
    from semantic_dsp_map_tpu_torch.benchmarks import prim_bench7
    from semantic_dsp_map_tpu_torch.ops import observe_cuda, phd, phd_cuda, probes_cuda
    from semantic_dsp_map_tpu_torch.ops.render_cuda import render_core_cuda

    dev = torch.device("cuda")
    cfg = virtual_kitti2_config()
    params = FilterParams(detection_probability=0.9, noise_number=0.1, if_consider_depth_noise=True)
    t, cloud, _ = phd_inputs(cfg)
    a_args = pass_a_inputs(cfg, params, t, cloud, torch.where(t.meta >= 0, t.weight, 0.0))
    b_args = pass_b_inputs(cfg, params, t, cloud, phd.stencil_pass_a(cfg, params, t, cloud))
    p, vst, vax = random_render_state(cfg)
    fargs, fp, fvax = observe_inputs(cfg)
    margs = (cfg, fp.track, fp.status, fp.stamp, fvax, 1)
    depth, rc = prim_bench7.make_inputs(dev)
    x = torch.randn((8, 128), device=dev)
    cases = (
        ("phd_pass_a", "dsp_pass_a", lambda: phd_cuda.pass_a_cuda(*a_args)),
        ("phd_pass_b", "dsp_pass_b", lambda: phd_cuda.pass_b_cuda(*b_args)),
        ("render", "dsp_render", lambda: render_core_cuda(cfg, p, vst, vax, 0.4)),
        ("front_candidates", "dsp_front_candidates",
         lambda: observe_cuda.front_candidates_cuda(*fargs)),
        ("movable_voxels", "dsp_movable_voxels", lambda: observe_cuda.movable_voxels_cuda(*margs)),
        ("gather", "dsp_gather", lambda: probes_cuda.gather_cuda(depth, rc)),
        ("scale2", "dsp_scale2", lambda: probes_cuda.scale2_cuda(x)),
    )
    mul = []
    for key, name, call in cases:
        wrapper, bare = launch_cost(name, call)
        mul += runs_in_turns([lambda: torch.mul(x, 2.0)], 200, 1)[0]["enqueue_ms"]
        w, b = float(np.median(wrapper)), float(np.median(bare))
        report[key].update(enqueue_ms=w, enqueue_ms_rounds=wrapper, bare_enqueue_ms=b,
                           bare_enqueue_ms_rounds=bare)
        print(f"[launch] {key} ({name}): host time per launch in runs of 200, median of 3 rounds "
              f"(spread): wrapper {w:.5f} ms ({spread(wrapper)}), bare ctypes call {b:.5f} ms "
              f"({spread(bare)}): the wrapper adds {w - b:.5f} ms ({card})")
    m = float(np.median(mul))
    for key in report:
        report[key]["mul_enqueue_ms"] = m
    print(f"[launch] torch.mul on [8, 128] f32: {m:.5f} ms a launch ({spread(mul)}), measured "
          f"after each wrapper ({card})")


# ---------------------------------------------------------------------------
# Phase 3: CUDA path vs CPU path on the tiny scenes
# ---------------------------------------------------------------------------

#: Runtime parameters of the tiny scenes (tests/test_full_frame_oracle.py):
#: no jitter, so both paths are deterministic.
TINY_PARAMS = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                   depth_noise_model_zero_order=0.2, prediction_stddev=0.0)
TINY_ZED2_PARAMS = dict(TINY_PARAMS, bayesian_movement_distance_threshold=0.2,
                        bayesian_movement_increment=0.4, bayesian_movement_decrement=0.05,
                        bayesian_movement_probability_threshold=0.3)


def tiny_scene(cfg, t, mask_cls):
    """The 10-frame dynamic scene of tests/test_full_frame_oracle.py."""
    H, W = cfg.height, cfg.width
    depth = np.full((H, W), 1.5873, np.float32)
    depth[:4, :] = 9.5111
    static = np.full((H, W), 6, np.uint8)
    car = np.zeros((H, W), np.uint8)
    car[8:16, 4 + t : 12 + t] = 1
    depth[car > 0] = 1.2157
    dx, dy = 0.15131, 0.02071
    base = np.array([[0.2071, 0, 1.2157], [0.6113, 0, 1.2157], [0.2071, -0.3041, 1.2157],
                     [0.6113, -0.3041, 1.2157], [0.2071, 0, 1.5119]], np.float32)
    kpts = (base + np.array([dx * t, dy * t, 0], np.float32)).astype(np.float32)
    masks = [
        mask_cls(track_id=65535, label="static", mask=static),
        mask_cls(track_id=3, label="Car", mask=car, kpts_current=kpts,
                 kpts_previous=kpts - np.array([dx, dy, 0], np.float32)),
    ]
    cam_pos = np.array([0.02133 * t, 0, 0.26177 * t], np.float32)
    return depth, masks, cam_pos, np.array([1, 0, 0, 0], np.float32), 0.15 * t


def tiny_zed2_scene(cfg, t, mask_cls):
    """The 10-frame ZED2 (bbox3d) scene of tests/test_full_frame_oracle.py:
    a culled sky band, mask bleed onto a far wall that the bbox gate
    demotes, a moving 4-corner-bbox car, 0.35 s frames."""
    H, W = cfg.height, cfg.width
    depth = np.full((H, W), 1.5873, np.float32)
    depth[:3, :] = 9.5111
    depth[:, 26:] = 3.0873
    static = np.full((H, W), 6, np.uint8)
    static[3:7, :] = 2
    car = np.zeros((H, W), np.uint8)
    car[9:16, 6 + t : 13 + t] = 1
    car[9:16, 26:29] = 1
    depth[9:16, 6 + t : 13 + t] = 1.2157
    dx, dy = 0.05131, 0.01071
    base = np.array([[0.0071, 0, 1.2157], [0.2184, 0, 1.2157], [0.0071, -0.2041, 1.2157],
                     [0.2184, -0.2041, 1.2157]], np.float32)
    kpts = (base + np.array([dx * t, dy * t, 0], np.float32)).astype(np.float32)
    masks = [
        mask_cls(track_id=65535, label="static", mask=static),
        mask_cls(track_id=4, label="Car", mask=car, kpts_current=kpts,
                 kpts_previous=kpts - np.array([dx, dy, 0], np.float32)),
    ]
    cam_pos = np.array([0.01133 * t, 0, 0.03177 * t], np.float32)
    return depth, masks, cam_pos, np.array([1, 0, 0, 0], np.float32), 0.35 * t


#: The small template scene (tests/torch_parity.py): a 96 x 72 camera over
#: a 16 x 8 x 32 grid and a match grid of 32^3 cells.
TINY_TPL_CFG = dict(image_width=96, image_height=72, camera_fx=60, camera_fy=60,
                    camera_cx=48, camera_cy=36, voxel_num_axis_z_n=5)
TINY_TPL_GRID = dict(grid_n=32, max_source_points=4096, max_template_points=2048, fs_ray_steps=96)
TINY_TPL_PARAMS = dict(if_use_template_matching=True, match_score_threshold=0.2,
                       nb_ptc_num_per_point=1, prediction_stddev=0.0)


def tiny_template_scene(cfg, t, mask_cls):
    """Frame t of the small template scene of tests/torch_parity.py: a wall,
    a static Car of 2,940 mask pixels, a camera drifting a quarter pixel per
    frame."""
    H, W = cfg.height, cfg.width
    depth = np.full((H, W), 3.5117, np.float32)
    car = np.zeros((H, W), np.uint8)
    car[20:62, 10:80] = 1
    depth[car > 0] = 3.0123
    kpts = np.array([[-1.2, 0, 3], [1.0, 0, 3], [-1.2, -0.6, 3], [1.0, -0.6, 3],
                     [-1.2, 0, 3.4]], np.float32)
    masks = [
        mask_cls(track_id=65535, label="static", mask=np.full((H, W), 6, np.uint8)),
        mask_cls(track_id=3, label="Car", mask=car, kpts_current=kpts, kpts_previous=kpts),
    ]
    cam_pos = np.array([0.01313 * t, 0.00517 * t, 0.0], np.float32)
    return depth, masks, cam_pos, np.array([1, 0, 0, 0], np.float32), 0.1 * t


def tiny_template_setup(dsp):
    """The small scene's match grid and the committed bank."""
    from semantic_dsp_map_tpu_torch.ops.templates import MatchGridConfig

    dsp._templates.grid = MatchGridConfig(**TINY_TPL_GRID)
    if dsp.set_template_path(str(TEMPLATES)) != 1:
        raise AssertionError("the template bank did not load")


def check_scene_cuda_vs_cpu(name, cfg, params, scene, counters, frames=10, setup=None,
                            need_moved=True):
    """The same scene through a CPU map and a CUDA map (default flags, so
    every kernel is on): counters equal, occ/label/track equal, weight_sum
    close, and every kernel launched once per frame on the CUDA side.
    ``setup`` runs on each map before the first frame.  Returns the last
    (CPU map, CUDA map)."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts, SemanticDSPMap

    cpu = SemanticDSPMap(cfg, params, device="cpu")
    gpu = SemanticDSPMap(cfg, params, device="cuda")
    if setup is not None:
        setup(cpu)
        setup(gpu)
    reset_launches(counters)
    moved = 0
    for t in range(frames):
        rc, dc = cpu.update(*scene(cfg, t, MaskKpts))
        rg, dg = gpu.update(*scene(cfg, t, MaskKpts))
        dcd = {k: int(v) for k, v in dc._asdict().items()}
        dgd = {k: int(v) for k, v in dg._asdict().items()}
        if dcd != dgd:
            raise AssertionError(f"{name} frame {t}: diagnostics {dgd} != CPU {dcd}")
        for field in ("occ", "label", "track"):
            assert_equal(f"{name} frame {t} {field}", getattr(rg, field).cpu(), getattr(rc, field))
        if not torch.allclose(rg.weight_sum.cpu(), rc.weight_sum, rtol=2e-4, atol=1e-6):
            raise AssertionError(f"{name} frame {t}: weight_sum differs")
        moved += dgd["moved_count"]
    launches = read_launches(counters)
    if any(c != frames for c in launches.values()):
        raise AssertionError(f"{name}: launches {launches} in {frames} frames")
    if need_moved and moved == 0:
        raise AssertionError(f"{name}: the rigid-move stage moved no particle")
    print(f"[tiny] {name}, {frames} frames: CUDA path equal to the CPU path "
          f"(moved {moved}, last diag {dgd}, launches {launches})")
    return cpu, gpu


def check_template_scene(counters):
    """The small template scene CUDA vs CPU for 3 frames with the birth
    jitter off (the two devices draw different normals): the birth sweeps
    on frame 0 on both devices with equal gate rows and scores, and the
    GUESSED_BORN particles agree."""
    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, template_engine, tiny_test_config
    from semantic_dsp_map_tpu_torch.state import STATUS_GUESSED_BORN

    noise = template_engine.GUESSED_BIRTH_NOISE
    template_engine.GUESSED_BIRTH_NOISE = 0.0
    try:
        cpu, gpu = check_scene_cuda_vs_cpu(
            "template scene", tiny_test_config(**TINY_TPL_CFG), FilterParams(**TINY_TPL_PARAMS),
            tiny_template_scene, counters, frames=3, setup=tiny_template_setup, need_moved=False)
    finally:
        template_engine.GUESSED_BIRTH_NOISE = noise
    sc, sg = list(cpu._templates.sweeps), list(gpu._templates.sweeps)
    if not sg or [s.stage for s in sg] != [s.stage for s in sc] or sg[0].stage != "birth":
        raise AssertionError(f"template scene: sweeps CUDA {sg} CPU {sc}")
    for a, b in zip(sc, sg):
        assert_equal("template scene gate row", torch.from_numpy(b.gate_row), torch.from_numpy(a.gate_row))
        assert_equal("template scene score", b.score.cpu(), a.score)
    pc, pg = cpu.state.particles, gpu.state.particles
    assert_equal("template scene status", pg.status.cpu(), pc.status)
    for f in ("px", "py", "pz", "weight"):
        assert_close(f"template scene {f}", getattr(pg, f).cpu(), getattr(pc, f))
    n_guessed = int((pc.status == STATUS_GUESSED_BORN).sum())
    if n_guessed == 0:
        raise AssertionError("template scene: no GUESSED_BORN particle")
    print(f"[tiny] template scene: birth sweep gate row {sg[0].gate_row.tolist()}, score "
          f"{float(sg[0].score):.6f} on both devices; {n_guessed} GUESSED_BORN particles "
          f"after 3 frames on both")


def random_map_state(cfg, seed=5):
    """random_render_state as a MapState on the card, with a scrolled map
    (axis stamps 0-1 against slot stamps 0-2)."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch.state import init_map_state

    p, vst, _ = random_render_state(cfg, seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    ri = lambda m: torch.randint(0, 2, (m,), generator=g, device="cuda", dtype=torch.int32)
    st = init_map_state(cfg, device="cuda")
    scroll = dataclasses.replace(st.scroll, axis_stamp_x=ri(cfg.nx), axis_stamp_y=ri(cfg.ny),
                                 axis_stamp_z=ri(cfg.nz))
    return dataclasses.replace(st, particles=p, voxel_stamp=vst, scroll=scroll)


def check_smoothed_render(cfg, label, against_cpu=True):
    """The neighbour-smoothed render (plain PyTorch, no kernel) at full
    shapes on the card, timed, and with ``against_cpu`` held against the
    same code on the CPU; returns its ms."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch.ops.render import render_occupancy_smoothed

    state = random_map_state(cfg)
    thr = 0.4
    if not against_cpu:
        _, rg = render_occupancy_smoothed(cfg, state, thr)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: render_occupancy_smoothed(cfg, state, thr), 3)
        occ = torch.bincount((rg.occ + 1).long(), minlength=4).tolist()
        print(f"[smoothed] {label} V={cfg.num_voxels} K={cfg.slots_per_voxel}: occ histogram "
              f"(-1,0,1,2) {occ}; {ms:.3f} ms on the card (not compared with the CPU)")
        return ms
    cpu_state = dataclasses.replace(
        state,
        particles=dataclasses.replace(state.particles, **{
            f.name: getattr(state.particles, f.name).cpu()
            for f in dataclasses.fields(state.particles)}),
        voxel_stamp=state.voxel_stamp.cpu(),
        scroll=dataclasses.replace(state.scroll, **{
            f.name: getattr(state.scroll, f.name).cpu() for f in dataclasses.fields(state.scroll)}),
    )
    pg, rg = render_occupancy_smoothed(cfg, state, thr)
    torch.cuda.synchronize()
    pc, rc = render_occupancy_smoothed(cfg, cpu_state, thr)
    for name in ("occ", "label", "track"):
        assert_equal(f"smoothed {label} {name}", getattr(rg, name).cpu(), getattr(rc, name))
    assert_equal(f"smoothed {label} new status", pg.status.cpu(), pc.status)
    assert_close(f"smoothed {label} weight_sum", rg.weight_sum.cpu(), rc.weight_sum)
    assert_close(f"smoothed {label} new weight", pg.weight.cpu(), pc.weight)
    err = max(max_err(rg.weight_sum.cpu(), rc.weight_sum)[0], max_err(pg.weight.cpu(), pc.weight)[0])
    ms = cuda_ms(lambda: render_occupancy_smoothed(cfg, state, thr), 3)
    occ = torch.bincount((rg.occ + 1).long(), minlength=4).tolist()
    print(f"[smoothed] {label} V={cfg.num_voxels} K={cfg.slots_per_voxel}: CUDA equal to CPU "
          f"(occ histogram (-1,0,1,2) {occ}, max abs {err:.3e}); {ms:.3f} ms on the card")
    return ms


# ---------------------------------------------------------------------------
# Phase 4: the main paths
# ---------------------------------------------------------------------------


def drive_main_path(name, cfg, params, synth, counters, card, warmup=3, frames=5,
                    template_path=None):
    """SemanticDSPMap.update() on ``cfg`` for warm-up + timed frames, with
    the launch counts set to 0 just before and read just after.  With
    ``template_path`` the map loads that bank and every template sweep is
    printed with its frame.  Returns (launches, median ms, map, per-frame
    ms, [(frame, sweep, GUESSED_BORN count after it)])."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts, SemanticDSPMap
    from semantic_dsp_map_tpu_torch.state import STATUS_GUESSED_BORN

    dsp = SemanticDSPMap(cfg, params, device="cuda")
    if template_path is not None:
        n_tpl = dsp.set_template_path(str(template_path))
        print(f"[{name}] {n_tpl} template(s) from {Path(template_path).relative_to(REPO)}, "
              f"match grid {dsp._templates.grid}")
        if n_tpl == 0:
            raise AssertionError(f"{name}: no template loaded")
    sweeps = []
    n_slots = cfg.num_voxels * cfg.slots_per_voxel
    print(f"[{name}] grid {cfg.nx}x{cfg.ny}x{cfg.nz} = {cfg.num_voxels} voxels, "
          f"K={cfg.slots_per_voxel}, {n_slots} slots, image {cfg.width}x{cfg.height}, "
          f"R={cfg.neighbor_half}, S={cfg.phd_pixel_table_slots}, "
          f"use_pallas_observe={cfg.use_pallas_observe}")
    scenes = [synth(cfg, t, MaskKpts) for t in range(warmup + frames)]
    torch.cuda.synchronize()

    reset_launches(counters)
    frame_ms, wall_ms, moved_any = [], [], False
    result = None
    for t, (depth, masks, pos, quat) in enumerate(scenes):
        n_sweeps = dsp._templates.n_sweeps if dsp._templates else 0
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        a.record()
        result, diag = dsp.update(depth, masks, pos, quat, 0.1 * t)
        b.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - w0) * 1e3)
        frame_ms.append(a.elapsed_time(b))
        d = {k: int(v) for k, v in diag._asdict().items()}
        moved_any |= d["moved_count"] > 0
        tag = "warm-up" if t < warmup else "timed"
        print(f"[{name}] frame {t} ({tag}): {frame_ms[-1]:.3f} ms (events), "
              f"{wall_ms[-1]:.3f} ms (host) on {card}; diag {d}")
        new = dsp._templates.n_sweeps - n_sweeps if dsp._templates else 0
        if new:
            guessed = int((dsp.state.particles.status == STATUS_GUESSED_BORN).sum())
            for sw in list(dsp._templates.sweeps)[-new:]:
                sweeps.append((t, sw, guessed))
                print(f"[{name}] frame {t}: {sw.stage} sweep, gate row {sw.gate_row.tolist()} "
                      "(valid, rematch, birth, track, label, points, x mm, y mm), "
                      f"score {float(sw.score):.6f}; {guessed} GUESSED_BORN particles after the frame")
    launches = read_launches(counters)

    n = warmup + frames
    timed = frame_ms[warmup:]
    occ = result.occ
    hist = {str(k - 1): int(c) for k, c in enumerate(torch.bincount((occ + 1).long(), minlength=4).tolist())}
    w = dsp.state.particles.weight
    n_nan = int(torch.isnan(w).sum())
    print(f"[{name}] per-frame ms over the {frames} timed frames: median {np.median(timed):.3f}, "
          f"min {np.min(timed):.3f}, max {np.max(timed):.3f} ({card})")
    print(f"[{name}] last frame occ histogram {hist}; NaN weights {n_nan}; launches {launches}")
    for fname, count in launches.items():
        if count != n:
            raise AssertionError(f"{name}: {fname} launched {count} times in {n} frames")
    if hist["1"] <= 0:
        raise AssertionError(f"{name}: no occupied voxel after the last frame")
    if not moved_any:
        raise AssertionError(f"{name}: the rigid-move stage moved no particle in any frame")
    if n_nan:
        raise AssertionError(f"{name}: {n_nan} NaN particle weights")
    if occ.shape != (cfg.num_voxels,):
        raise AssertionError(f"{name}: occ has shape {tuple(occ.shape)}")
    return launches, float(np.median(timed)), dsp, frame_ms, sweeps


class CallRecorder:
    """Stands in for a kernel wrapper in its module for one frame: keeps a
    copy of each call's tensor arguments, and of the tensors of a dataclass
    argument (the frame step, and the render itself, update the store in
    place afterwards) and passes the call on.  The wrapper adds its launch to
    the ``launches`` of whatever its module holds under its name: here."""

    def __init__(self, module, name):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.calls, self.launches = [], 0

    def __call__(self, *args):
        import dataclasses

        import torch

        def keep(a):
            if isinstance(a, torch.Tensor):
                return a.clone()
            if dataclasses.is_dataclass(a) and not isinstance(a, type):
                held = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
                tensors = {k: v.clone() for k, v in held.items() if isinstance(v, torch.Tensor)}
                return dataclasses.replace(a, **tensors) if tensors else a
            return a

        self.calls.append(tuple(keep(a) for a in args))
        return self.fn(*args)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def check_real_frame(dsp, synth, t, card, other=None):
    """One more frame through ``dsp``'s eager step; the arguments it hands to the
    PHD passes (the frame's pixel table, cloud and ck_kappa), to the
    candidate scan (the particle store before the frame) and to the render
    (the store after it, before the render's clamp and collection) then go
    through the four kernels alone: against the plain version once, then
    timed.  With ``other`` (a build of another version of the sources) the
    two versions are timed in turns.  Returns the numbers."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.map import build_frame_step, unpack_frame
    from semantic_dsp_map_tpu_torch.ops import observe_cuda, phd_cuda, render_cuda
    from semantic_dsp_map_tpu_torch.ops.observe import front_candidates_plain, movable_voxels_plain

    depth, masks, pos, quat = synth(dsp.cfg, t, MaskKpts)
    # The map's own frames replay a captured graph, which calls no wrapper:
    # this frame runs the eager step on the map's state (taken over by the
    # map on its next frame).
    step = build_frame_step(dsp.cfg, dsp.params, dsp.registry)
    buf = pack_frame(dsp.cfg, dsp.registry, depth, masks, pos, quat, 0.1 * t - dsp._time_origin)
    f = unpack_frame(dsp.cfg, dsp._static_table, torch.from_numpy(buf).cuda())
    with (CallRecorder(phd_cuda, "pass_a_cuda") as rec_a,
          CallRecorder(phd_cuda, "pass_b_cuda") as rec_b,
          CallRecorder(observe_cuda, "front_candidates_cuda") as rec_f,
          CallRecorder(render_cuda, "render_core_cuda") as rec_r):
        dsp.state, _, _ = step(dsp.state, f)
    torch.cuda.synchronize()
    recorders = (rec_a, rec_b, rec_f, rec_r)
    if any((len(r.calls), r.launches) != (1, 1) for r in recorders):
        raise AssertionError("real frame: calls and launches of pass A, pass B, front, render: "
                             f"{[(len(r.calls), r.launches) for r in recorders]}")
    out = {"frame": t}

    args = rec_a.calls[0]
    S, H, W = args[5].shape
    ck_k, (a_abs, _) = check_pass_a(f"real frame {t}", args)
    census = pass_a_census(args)
    b, _, b_all = pass_a_bound(args, ck_k, census)
    run_a = lambda: phd_cuda.pass_a_cuda(*args)
    ms, q_ms = cuda_ms(run_a, 10), cuda_ms(run_a, 10, queued=True)
    out["pass_a"] = {"ms": ms, "queued_ms": q_ms, "max_abs_err": a_abs, **census, **b}
    print(f"[real] frame {t} pass A: table S={S} H={H} W={W}, {census['live_entries']} live entries "
          f"(share {census['live_entries'] / (S * H * W):.4f}), {census['terms']} terms in "
          f"{census['lane_iterations']} lane-iterations ({census['term_share']:.4f} of them terms); "
          f"within tolerance of the plain version (max abs {a_abs:.3e}), two launches bit-equal; "
          f"kernel {ms:.4f} ms ({q_ms:.4f} with the launch queued), bound {b['bound_ms']:.4f} ms by "
          f"{b['bound_by']} (every entry read whole: {b_all['bound_ms']:.4f} ms) ({card})")
    if other is not None:
        out["pass_a"].update(compare_pass_a(other, "real frame", args, card))
    del args, ck_k

    args = rec_b.calls[0]
    trk_eff = args[5]
    S, H, W = trk_eff.shape
    occupied = trk_eff != -2
    occ_share = float(occupied.float().mean())
    # entries per block of the kernel (B_TH x B_TW = 4 x 32 pixels in csrc/phd.cu)
    per_tile = torch.nn.functional.avg_pool2d(
        occupied.sum(0).float()[None, None], (4, 32), ceil_mode=True, divisor_override=1).flatten()
    acc_k, right_k, (b_abs, _), _ = check_pass_b(f"real frame {t}", args)
    b, n_bytes, terms = pass_b_bound(args, acc_k, right_k)
    run_b = lambda: phd_cuda.pass_b_cuda(*args)
    ms, q_ms = cuda_ms(run_b, 10), cuda_ms(run_b, 10, queued=True)
    out["pass_b"] = {"ms": ms, "queued_ms": q_ms, "occupied_share": occ_share, "entries": int(occupied.sum()),
                     "terms": terms, "max_abs_err": b_abs, **b}
    print(f"[real] frame {t} pass B: table S={S} H={H} W={W}, {int(occupied.sum())} occupied "
          f"entries (share {occ_share:.4f}; per 32 x 4 tile mean {float(per_tile.mean()):.1f}, "
          f"max {int(per_tile.max())}, empty tiles {int((per_tile == 0).sum())} of "
          f"{per_tile.numel()}), {terms} terms; equal to the plain version (max abs {b_abs:.3e}); "
          f"kernel {ms:.4f} ms ({q_ms:.4f} with the launch queued), bound {b['bound_ms']:.4f} ms "
          f"by {b['bound_by']} ({card})")
    if other is not None:
        o, n = ms_in_turns(run_b, other)
        out["pass_b"].update(other_ms=o, own_ms=n)
        print(f"[against] real frame pass B: {turns_line(o, n)} ({card})")
    del args, acc_k, right_k

    fargs = rec_f.calls[0]
    ha_p, hc_p = front_candidates_plain(*fargs)
    ha_k, hc_k = observe_cuda.front_candidates_cuda(*fargs)
    torch.cuda.synchronize()
    assert_equal(f"real frame {t} front has_alive", ha_k, ha_p)
    assert_equal(f"real frame {t} front has_cand", hc_k, hc_p)
    b, n_alive, (b_stamps, b_all) = front_bound(fargs, ha_k, hc_k)
    n = fargs[4].numel()
    run_f = lambda: observe_cuda.front_candidates_cuda(*fargs)
    ms, q_ms = cuda_ms(run_f, 10), cuda_ms(run_f, 10, queued=True)
    out["front_candidates"] = {"ms": ms, "queued_ms": q_ms, "alive_share": n_alive / n, "alive_slots": n_alive,
                               "alive_voxels": int(ha_k.sum()), "candidate_voxels": int(hc_k.sum()),
                               **b}
    print(f"[real] frame {t} front scan: {n_alive} of {n} slots alive (share {n_alive / n:.4f}), "
          f"{int(ha_k.sum())} voxels with a live slot, {int(hc_k.sum())} candidate voxels; bytes "
          f"equal to the plain version; kernel {ms:.4f} ms ({q_ms:.4f} with the launch queued), "
          f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (every slot's stamp read: "
          f"{b_stamps:.4f} ms; all slots' positions too: {b_all:.4f} ms) ({card})")
    if other is not None:
        o, n2 = ms_in_turns(run_f, other)
        out["front_candidates"].update(other_ms=o, own_ms=n2)
        print(f"[against] real frame front scan: {turns_line(o, n2)} ({card})")
    del fargs

    cfg, p, vst, vax, thr = rec_r.calls[0]
    pk, r_k, (e1, e2), bits = check_render_once(f"real frame {t}", cfg, p, vst, vax, thr)
    c = render_census(cfg, p, pk, vax, vst, r_k)
    run_r, restore = render_runner(cfg, p, vst, vax, thr)
    ms, q_ms = cuda_ms(run_r, 10, setup=restore), cuda_ms(run_r, 10, queued=True, setup=restore)
    out["render"] = {"ms": ms, "queued_ms": q_ms, "max_abs_err": max(e1, e2), "sums_bit_equal": bits,
                     **{k: v for k, v in c.items() if k != "bound"}, **c["bound"]}
    print(f"[real] frame {t} render: {census_line(c)}; occ, label, track, status equal to the plain "
          f"version, sums bit-equal: {bits}; kernel {ms:.4f} ms ({q_ms:.4f} with the launch queued) "
          f"({card})")
    if other is not None:
        out["render"].update(compare_render(other, "real frame", cfg, p, vst, vax, thr, card))
    return out


def time_template_sweep(dsp, synth, t):
    """The birth sweep of frame ``t`` alone: the car's cloud rebuilt from the
    frame, compacted and swept against the bank (template_match_bank, FS
    variant), timed on the card; its score must equal the main path's."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.map import unpack_frame
    from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices
    from semantic_dsp_map_tpu_torch.ops.projection import generate_labeled_cloud
    from semantic_dsp_map_tpu_torch.ops.templates import template_match_bank
    from semantic_dsp_map_tpu_torch.template_engine import _extract_track_points

    cfg, eng = dsp.cfg, dsp._templates
    depth, masks, pos, quat = synth(cfg, t, MaskKpts)
    buf = torch.from_numpy(pack_frame(cfg, dsp.registry, depth, masks, pos, quat, 0.0)).cuda()
    f = unpack_frame(cfg, dsp._static_table, buf)
    r_wc, t_wc, _, _ = camera_matrices(f.cam_pos, f.cam_quat)
    cloud = generate_labeled_cloud(cfg, dsp.params, f.depth, f.track_raster, f.track_label_table,
                                   r_wc, t_wc, dsp.registry.max_movable_instance_id)
    tpls, tvalids = eng.bank.of_label(dsp.registry.label_to_id["Car"])
    tpls, tvalids = torch.from_numpy(tpls).cuda(), torch.from_numpy(tvalids).cuda()
    car = next(m.track_id for m in masks if m.label == "Car")

    def sweep():
        pts, ok = _extract_track_points(eng.grid.max_source_points, cloud, car)
        return template_match_bank(eng.grid, True, pts, ok, f.cam_pos, tpls, tvalids)

    _, score, _ = sweep()
    return cuda_ms(sweep, 5), float(score)


def profile_main_path(dsp, synth, card, first_t=8, frames=3, out_dir=REPO / "chiprun_out"):
    """torch.profiler over a few more frames: device time by kernel, the
    device's busy share of the wall time, and a chrome trace."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts
    from torch.profiler import ProfilerActivity, profile

    scenes = [synth(dsp.cfg, t, MaskKpts) for t in range(first_t, first_t + frames)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for t, (depth, masks, pos, quat) in enumerate(scenes, start=first_t):
            dsp.update(depth, masks, pos, quat, 0.1 * t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[profile] {frames} frames on {card}: wall {wall_ms / frames:.3f} ms/frame, "
          f"device busy {device_ms / frames:.3f} ms/frame "
          f"({100 * device_ms / wall_ms:.1f}% busy, {100 - 100 * device_ms / wall_ms:.1f}% idle)")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:25]:
        print(f"[profile] {e.self_device_time_total / 1e3 / frames:9.3f} ms/frame "
              f"{e.count // frames:6d} launches/frame  {e.key[:110]}")
    n_launch = sum(e.count for e in events) // frames
    print(f"[profile] {n_launch} device launches per frame")
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"profile_trace_{dsp.cfg.width}x{dsp.cfg.height}.json"))


def reset_launches(counters):
    """Set the launch counts of ``counters`` (kernel wrappers) to 0, and
    those the captured frame steps keep (``step_graph.captured`` and
    ``replayed``)."""
    from semantic_dsp_map_tpu_torch import step_graph

    for fn in counters:
        fn.launches = 0
    step_graph.captured.clear()
    step_graph.replayed.clear()


def read_launches(counters):
    """How often each wrapper's kernel ran since ``reset_launches``: its
    launches outside graphs plus those captured into a graph times the
    graph's replays (``step_graph.kernel_runs``)."""
    from semantic_dsp_map_tpu_torch import step_graph

    return {fn.__name__: step_graph.kernel_runs(fn) for fn in counters}


def drive_replay(counters, card, n_frames=13, drop_first=2):
    """The replay path: ``n_frames`` VKITTI2 frames written with
    datasets.save_npz_frame, then replay.main on them with the default
    device (the card) and default runtime parameters, PLY clouds every 5
    mapped frames.  Every mapped frame must launch each frame kernel once;
    the PLY files must read back; the last frame must leave occupied voxels.
    Returns (launches, ms per mapped frame)."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts, replay, virtual_kitti2_config
    from semantic_dsp_map_tpu_torch.datasets import Frame, NpzSequence, save_npz_frame
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.io import read_ply
    from semantic_dsp_map_tpu_torch.labels import LabelRegistry

    cfg = virtual_kitti2_config()
    mapped = n_frames - drop_first
    with tempfile.TemporaryDirectory(prefix="replay_") as tmp:
        data, out = Path(tmp) / "frames", Path(tmp) / "out"
        frames = []
        for t in range(n_frames):
            depth, masks, pos, quat = bench_scenes().synth_vkitti2_frame(cfg, t, MaskKpts)
            frames.append(Frame(depth, masks, pos, quat, 0.1 * t, t))
            save_npz_frame(str(data), t, frames[-1])
        # a frame that went through the files packs to the same bytes
        reg = LabelRegistry.default()
        back = list(NpzSequence(str(data)))
        for a, b in ((frames[0], back[0]), (frames[-1], back[-1])):
            pa = pack_frame(cfg, reg, a.depth, a.masks, a.cam_pos, a.cam_quat, a.time)
            pb = pack_frame(cfg, reg, b.depth, b.masks, b.cam_pos, b.cam_quat, b.time)
            if pa.tobytes() != pb.tobytes():
                raise AssertionError(f"replay: frame {a.index} packs differently after the npz files")

        reset_launches(counters)
        summary, result = replay.main([
            "--dataset", "npz", "--data", str(data), "--preset", "vkitti2", "--out", str(out),
            "--ply-every", "5", "--drop-first", str(drop_first)])
        launches = read_launches(counters)

        if result.occ.device.type != "cuda":
            raise AssertionError(f"replay: the default device gave a result on {result.occ.device}")
        if summary["frames"] != mapped:
            raise AssertionError(f"replay: mapped {summary['frames']} frames, expected {mapped}")
        for fname, count in launches.items():
            if count != mapped:
                raise AssertionError(f"replay: {fname} launched {count} times in {mapped} frames")
        occupied = int((result.occ == 1).sum())
        if occupied <= 0:
            raise AssertionError("replay: no occupied voxel after the last frame")
        plys = sorted(q.name for q in out.glob("*.ply"))
        # mapped frames 5 and 10 are sequence frames 6 and 11
        want = ["final_occupied.ply", "frame_000006_occupied.ply", "frame_000011_occupied.ply"]
        if plys != want:
            raise AssertionError(f"replay: PLY files {plys}, expected {want}")
        xyz, rgb = read_ply(str(out / "final_occupied.ply"))
        if xyz.shape[0] <= 0 or xyz.shape[1] != 3 or rgb is None or rgb.shape != xyz.shape:
            raise AssertionError(f"replay: final PLY holds xyz {xyz.shape}")
        if not np.isfinite(xyz).all():
            raise AssertionError("replay: non-finite PLY vertices")
    ms = 1e3 / summary["fps"]
    print(f"[replay] {mapped} mapped frames of {n_frames} at VKITTI2 width on the default device: "
          f"{ms:.3f} ms per frame (host clock to occ on the host, frame 2 is the map's first), "
          f"{occupied} occupied voxels, final PLY {xyz.shape[0]} vertices, PLY files {plys}, "
          f"launches {launches} ({card})")
    return launches, ms


def drive_soak(counters, card, frames=40):
    """The KITTI-360 soak (tools.soak.main: kitti360_config, nothing cut but
    the frame count) on the default device.  All three checks must be true;
    every frame, the five after the restore included, launches each frame
    kernel once.  Returns (launches, report)."""
    from semantic_dsp_map_tpu_torch.tools import soak

    out = REPO / "chiprun_out" / "SOAK_KITTI360.json"
    reset_launches(counters)
    report = soak.main(["--frames", str(frames), "--out", str(out)])
    launches = read_launches(counters)
    n = frames + soak.RESUME_FRAMES
    for fname, count in launches.items():
        if count != n:
            raise AssertionError(f"soak: {fname} launched {count} times in {n} frames")
    for key in ("occupied_in_ego_window", "behind_region_unknown", "resumed_occ_equal"):
        if report[key] is not True:
            raise AssertionError(f"soak: {key} is {report[key]}")
    if report["occupied_final"] <= 0:
        raise AssertionError("soak: no occupied voxel after the last frame")
    print(f"[soak] kitti360, {frames} frames + {soak.RESUME_FRAMES} after the restore: "
          f"{1e3 * report['sec_per_frame']:.1f} ms per frame (host clock, frame synthesis and the "
          f"checkpoint included), update() alone median {report['frame_ms_median']:.3f} ms, "
          f"state {report['state_bytes']} bytes, checkpoint {report['checkpoint_mb']} MB, peak "
          f"device memory {report['peak_memory_bytes']} bytes, launches {launches} ({card})")
    return launches, report


def run_probe_modules(probe_counters, card, iters=10):
    """The two primitive-op probe modules, whose tables carry the card on
    every line; they are the path of the gather and x2 kernels.  Returns
    (launches, rows of both)."""
    from semantic_dsp_map_tpu_torch.benchmarks import prim_bench1, prim_bench7

    reset_launches(probe_counters)
    argv = ["--iters", str(iters)]
    rows = {"prim_bench1": prim_bench1.main(argv), "prim_bench7": prim_bench7.main(argv)}
    launches = read_launches(probe_counters)
    # each module holds one line for its kernel: a warm-up and ``iters`` timed calls
    for fname, count in launches.items():
        if count != iters + 1:
            raise AssertionError(f"probes: {fname} launched {count} times, expected {iters + 1}")
    print(f"[probes] launches {launches} ({card})")
    return launches, rows


#: The StepDiagnostics counters that say a capacity cap bound.
CAP_COUNTERS = ("block_overflow", "entry_overflow", "table_dropped", "corner_overflow",
                "move_overflow", "birth_overflow")


def frame_quantities(result, diag):
    """A frame's nine counters and its counts of occupied, free and unknown
    voxels, as the files under data/bench_expected hold them."""
    row = {k: int(v) for k, v in diag._asdict().items()}
    occ = result.occ
    row.update(occupied=int((occ == 1).sum()), free=int((occ == 0).sum()),
               unknown=int((occ == -1).sum()))
    return row


def check_expected(counters, card, record=False):
    """The card against the full-size files under data/bench_expected: the
    hostile and the vkitti2 scene at ``virtual_kitti2_config()`` with
    ``prediction_stddev=0.0``, every frame of a file; and under
    off_boundaries/ the hostile scene with its cars 0.07 m off their exact
    depths, where no voxel boundary decides anything.  A file holds what the
    JAX package gave on the CPU and, where the port's CPU path gave another
    integer, that one beside it (``port_cpu``); where the card is known to
    give a third, that one (``card``).  The card is held to the last of these
    that a quantity has; such a quantity is printed with the word OPEN.
    Every other quantity must equal the JAX package's.  What the card gave
    goes to chiprun_out/EXPECTED_CARD.json; with ``record`` a parting is
    printed and does not fail the run, so that ``tests/make_bench_expected.py
    card`` can enter the card's values into the files.  Returns the summary
    per scene."""
    from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, SemanticDSPMap, virtual_kitti2_config

    scenes = bench_scenes()
    cfg = virtual_kitti2_config()
    params = FilterParams(**dict(scenes.VK_PARAMS, prediction_stddev=0.0))
    summary, seen = {}, {}
    files = sorted(EXPECTED.glob("*.json")) + sorted((EXPECTED / "off_boundaries").glob("*.json"))
    for path in files:
        with open(path) as f:
            doc = json.load(f)
        name = doc["scene"] + ("_off_boundaries" if path.parent.name == "off_boundaries" else "")
        synth = getattr(scenes, doc["synth"].rsplit(".", 1)[1])
        dsp = SemanticDSPMap(cfg, params, device="cuda")
        reset_launches(counters)
        opened, parted, rows = [], [], []
        for frame in doc["frames"]:
            t = frame["t"]
            depth, masks, pos, quat = synth(cfg, t, MaskKpts, **doc["synth_kwargs"])
            got = frame_quantities(*dsp.update(depth, masks, pos, quat, 0.1 * t))
            for q, jax_value in frame["jax"].items():
                want, held_to = jax_value, "the JAX package"
                for column, who in (("port_cpu", "the port on the CPU"), ("card", "this card's record")):
                    if q in frame.get(column, {}):
                        want, held_to = frame[column][q], who
                if held_to != "the JAX package":
                    opened.append([t, q, jax_value, frame.get("port_cpu", {}).get(q), got[q]])
                    print(f"[expected] {name} frame {t} {q}: OPEN: the JAX package {jax_value}, the "
                          f"port on the CPU {frame.get('port_cpu', {}).get(q, jax_value)}, the card "
                          f"{got[q]} (held to {held_to}: {want})")
                if got[q] != want:
                    parted.append((t, q, got[q], want, held_to))
            rows.append(got)
            print(f"[expected] {name} frame {t}: {got}")
        launches = read_launches(counters)
        n = len(doc["frames"])
        seen[name] = rows
        if parted:
            lines = "; ".join(f"frame {t} {q}: card {g}, {who} {w}" for t, q, g, w, who in parted)
            if not record:
                raise AssertionError(f"expected {name}: the card parts from {path.name}: {lines}")
            print(f"[expected] {name} PARTS from {path.name} (recorded, not failed): {lines}")
        for fname, count in launches.items():
            if count != n:
                raise AssertionError(f"expected {name}: {fname} launched {count} times in {n} frames")
        summary[name] = {"frames": n, "equal": not parted, "open": opened, "launches": launches}
        print(f"[expected] {name}: {n} frames on the card equal to {path.relative_to(REPO)} "
              f"({len(opened)} quantities OPEN, {12 * n - len(opened)} held to the JAX package's; "
              f"launches {launches}) ({card})")
        del dsp
    if set(summary) != {"vkitti2_hostile", "vkitti2", "vkitti2_hostile_off_boundaries"}:
        raise AssertionError(f"expected: files for {sorted(summary)} under {EXPECTED}")
    out = REPO / "chiprun_out" / "EXPECTED_CARD.json"
    out.parent.mkdir(exist_ok=True)
    with open(out, "w") as f:
        json.dump({"card": card, "scenes": seen}, f, indent=1)
    return summary


def reduced_hostile_scene(cfg, t, mask_cls):
    """The hostile scene for the CUDA-against-CPU check: the cars 0.07 m off
    their exact depths (off the voxel boundaries, where the last bit of a
    moved particle's position decides its voxel), with the frame's time."""
    return (*bench_scenes().synth_hostile_frame(cfg, t, mask_cls, car_depth_offset=0.07), 0.1 * t)


def run_bench(counters, card):
    """``benchmarks.bench.main --iters 50`` on the card: four cells at full
    width, 3 warm-up frames and 3 timed loops of 50 / 25 / 25 / 25 frames
    each, one synchronize a loop.  Every cell must launch each frame kernel
    once per frame, leave occupied voxels and no NaN weight; the template
    cell must sweep a birth and leave GUESSED_BORN particles; the hostile
    cell must move particles and overflow the move cap.  Each cell's peak
    counters are printed beside those the JAX package recorded for the same
    scene (BENCH_DETAILS.json, read as data; its rates are not used) and,
    where data/bench_expected/jitter/ has the cell, beside those the JAX
    package gives on the CPU over the same frames; a cap counter that is
    zero on one side and not on the other is printed as a FINDING (against
    the CPU run where there is one).
    Returns (the cells, the launches of all cells)."""
    from semantic_dsp_map_tpu_torch.benchmarks import bench

    out = REPO / "chiprun_out" / "BENCH_CELLS.json"
    out.parent.mkdir(exist_ok=True)
    reset_launches(counters)
    cells = bench.main(["--iters", "50", "--out", str(out)])
    launches = read_launches(counters)
    with open(REPO / "BENCH_DETAILS.json") as f:
        recorded = {name: cell["peak_diag"] for name, cell in json.load(f).items()
                    if "peak_diag" in cell}

    if list(cells) != ["zed2", "vkitti2", "vkitti2_template", "vkitti2_hostile"]:
        raise AssertionError(f"bench: cells {list(cells)}")
    n_all = 0
    for name, cell in cells.items():
        n = cell["warmup"] + len(cell["runs"]) * cell["frames"]
        n_all += n
        if cell["frames"] != (50 if name == "zed2" else 25) or len(cell["runs"]) < 3:
            raise AssertionError(f"bench {name}: {cell['frames']} frames x {len(cell['runs'])} runs")
        for fname, count in cell["kernel_launches"].items():
            if count != n:
                raise AssertionError(f"bench {name}: {fname} launched {count} times in {n} frames")
        if cell["nan_weights"]:
            raise AssertionError(f"bench {name}: {cell['nan_weights']} NaN particle weights")
        if cell["occ_histogram"]["1"] <= 0:
            raise AssertionError(f"bench {name}: no occupied voxel after the last frame")
        if cell["peak_diag"]["moved_count"] <= 0:
            raise AssertionError(f"bench {name}: no particle moved in any timed frame")
        # the first loop's frames are the frames of the JAX bench's one loop
        peak, rec = cell["runs"][0]["peak_diag"], recorded[name]
        print(f"[bench] {name} peak_diag on the card, all {len(cell['runs'])} loops: {cell['peak_diag']}")
        print(f"[bench] {name} peak_diag on the card, first loop: {peak}")
        print(f"[bench] {name} peak_diag the JAX package recorded: {rec}")
        jitter = EXPECTED / "jitter" / f"{name}.json"
        if jitter.exists():
            # the same cell through the JAX package on the CPU (its own draws
            # of the move jitter), the same frames as the first loop
            with open(jitter) as f:
                rows = [fr["jax"] for fr in json.load(f)["frames"]][cell["warmup"]:][:cell["frames"]]
            on_cpu = {q: max(row[q] for row in rows) for q in peak}
            print(f"[bench] {name} peak_diag of the JAX package on the CPU, frames "
                  f"{cell['warmup']}-{cell['warmup'] + len(rows) - 1}: {on_cpu}")
            rec = on_cpu if len(rows) == cell["frames"] else rec
        for q in CAP_COUNTERS:
            if (peak[q] > 0) != (rec[q] > 0):
                print(f"[bench] {name} FINDING: {q} is {peak[q]} on the card and {rec[q]} in the "
                      "JAX package's record")
    for fname, count in launches.items():
        if count != n_all:
            raise AssertionError(f"bench: {fname} launched {count} times in {n_all} frames")
    tpl = cells["vkitti2_template"]
    if "birth" not in tpl["template_sweeps"] or tpl["guessed_born_in_warmup"] <= 0:
        raise AssertionError(f"bench vkitti2_template: sweeps {tpl['template_sweeps']}, "
                             f"{tpl['guessed_born_in_warmup']} GUESSED_BORN particles")
    hostile = cells["vkitti2_hostile"]["peak_diag"]
    if hostile["move_overflow"] <= 0:
        raise AssertionError(f"bench vkitti2_hostile: the move cap did not bind: {hostile}")
    # where the hostile cell's extra host time goes: its 21 masks in pack_frame
    from semantic_dsp_map_tpu_torch import virtual_kitti2_config
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.labels import LabelRegistry

    scenes, cfg, reg = bench_scenes(), virtual_kitti2_config(), LabelRegistry.default()
    pack_ms = {}
    for name, synth in (("vkitti2", scenes.synth_vkitti2_frame),
                        ("vkitti2_hostile", scenes.synth_hostile_frame)):
        frame = synth(cfg, 5)
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            pack_frame(cfg, reg, *frame, 0.5)
            times.append((time.perf_counter() - t0) * 1e3)
        pack_ms[name] = float(np.median(times))
        cells[name]["pack_frame_ms"] = pack_ms[name]
    print(f"[bench] pack_frame alone on the host, median of 7: vkitti2 (2 masks) "
          f"{pack_ms['vkitti2']:.3f} ms, vkitti2_hostile (21 masks) "
          f"{pack_ms['vkitti2_hostile']:.3f} ms")
    print(f"[bench] four cells, {n_all} frames, launches {launches}; template cell: sweeps "
          f"{tpl['template_sweeps']}, {tpl['guessed_born_in_warmup']} GUESSED_BORN particles after "
          f"a warm-up frame ({card})")
    return cells, launches


#: The report's key and the profiler's kernel name of each wrapper of
#: ``step_graph.FRAME_KERNELS``, in its order.
FRAME_KERNEL_NAMES = (("phd_pass_a", "pass_a_kernel"), ("phd_pass_b", "pass_b_kernel"),
                      ("render", "render_kernel"), ("front_candidates", "front_kernel"),
                      ("movable_voxels", "movable_kernel"))


def states_differ(a, b):
    """Names of the leaves of two map states (on the card) that are not
    bit-equal, the generators' seed and offset included."""
    import dataclasses

    import torch

    pairs = [(n, getattr(a, n), getattr(b, n))
             for n in ("voxel_stamp", "global_time", "prev_frame_time")]
    for group in ("particles", "scroll", "objects"):
        x, y = getattr(a, group), getattr(b, group)
        pairs += [(f"{group}.{f.name}", getattr(x, f.name), getattr(y, f.name))
                  for f in dataclasses.fields(x)]
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    out = [n for n, x, y in pairs if not torch.equal(bits(x), bits(y))]
    if not torch.equal(a.rng.get_state(), b.rng.get_state()):
        out.append("rng")
    return out


def movable_bound(cfg, state):
    """The movable scan's bound on ``state``'s store (the store a frame's
    scan reads), counting what this store needs: the status of every slot,
    the stamp of the slots whose status is set, the track of the alive ones,
    the voxel axis stamps and the output, at the memory rate.  Returns
    (bound, slots with a status, alive slots)."""
    from semantic_dsp_map_tpu_torch.ops import codecs
    from semantic_dsp_map_tpu_torch.state import STATUS_INVALID

    p, V, K = state.particles, cfg.num_voxels, cfg.slots_per_voxel
    vax = codecs.axis_stamps_per_voxel(cfg, state.scroll)
    n_set = int((p.status != STATUS_INVALID).sum())
    n_alive = int(codecs.particle_alive(p.status.view(V, K), p.stamp.view(V, K), vax).sum())
    return bound(nbytes(p.status, vax) + V + 4 * n_set + 4 * n_alive), n_set, n_alive


def profile_frame(run):
    """torch.profiler around one call of ``run`` (a frame, ended by a
    synchronize): (host API calls, device ms by kernel name, device busy ms,
    wall ms, kernel launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e3
    events = prof.events()
    api = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
              and e.name.startswith("cu"))
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {e.key: (e.self_device_time_total / 1e3, e.count) for e in device}
    busy = sum(ms for ms, _ in by_name.values())
    return api, by_name, busy, wall, sum(n for _, n in by_name.values())


@contextlib.contextmanager
def sync_debug_errors():
    """Inside the block an op that synchronizes the card with the host
    raises (``torch.cuda.set_sync_debug_mode``; PyTorch calls the mode a
    prototype that does not see every such op: a capture refuses them all)."""
    import warnings

    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def drive_graph(name, cfg, params, synth, counters, card, frames=10):
    """[graph]: ``SemanticDSPMap.update()`` (frame 0 eager, frame 1 captured
    into a CUDA graph and replayed, replays after) in turns with the eager
    step (``build_frame_step``'s two parts on a state of its own, fed the
    same packed frame: ``pack_frame``, the copy and the unpack included; on
    frame 1 the captured part under the sync debug mode "error"), ``frames``
    frames from one seed, the presets' noise on: state (the generator's seed
    and offset too), render and counters bit-equal every frame.  Then one
    more frame of each under torch.profiler: host API calls a frame, device
    busy share, and the five kernels' device time inside the replay.
    Returns the numbers."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts, SemanticDSPMap, step_graph
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.map import build_frame_stages, unpack_frame
    from semantic_dsp_map_tpu_torch.state import init_map_state

    reset_launches(counters)
    dsp = SemanticDSPMap(cfg, params, device="cuda")
    stages = build_frame_stages(cfg, params, dsp.registry)
    box = {"state": init_map_state(cfg, 0, "cuda")}
    scenes = [synth(cfg, t, MaskKpts) for t in range(frames + 1)]
    outside = step_graph.objects_outside_graph(cfg)

    def graph_frame(t):
        return dsp.update(*scenes[t], 0.1 * t)

    def eager_frame(t):
        # build_frame_step's step, in its two parts; on frame 1 the part the
        # card captures runs under the sync debug mode "error", which raises
        # on an op that synchronizes with the host.
        buf = pack_frame(cfg, dsp.registry, *scenes[t], 0.1 * t)
        f = unpack_frame(cfg, dsp._static_table, torch.from_numpy(buf).cuda())
        checked = contextlib.nullcontext() if t != 1 else sync_debug_errors()
        if outside:
            objects = stages.objects(box["state"], f)
        with checked:
            if not outside:
                objects = stages.objects(box["state"], f)
            box["state"], result, diag = stages.rest(box["state"], f, objects)
        return result, diag

    modes = {"graph": graph_frame, "eager": eager_frame}
    ms = {m: [] for m in modes}
    wall = {m: [] for m in modes}
    work = {m: [] for m in modes}
    for t in range(frames):
        out = {}
        for mode in (("graph", "eager") if t % 2 == 0 else ("eager", "graph")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            w0 = time.perf_counter()
            a.record()
            out[mode] = modes[mode](t)
            b.record()
            torch.cuda.synchronize()
            wall[mode].append((time.perf_counter() - w0) * 1e3)
            ms[mode].append(a.elapsed_time(b))
            work[mode].append(torch.cuda.max_memory_allocated() - resident)
        parted = states_differ(dsp.state, box["state"])
        (rg, dg), (re, de) = out["graph"], out["eager"]
        parted += [f for f in rg._fields if not torch.equal(getattr(rg, f), getattr(re, f))]
        dgd = {k: int(v) for k, v in dg._asdict().items()}
        if dgd != {k: int(v) for k, v in de._asdict().items()}:
            parted.append("diagnostics")
        if parted:
            raise AssertionError(f"[graph] {name} frame {t}: the graph parts from the eager step "
                                 f"in {parted}")
        print(f"[graph] {name} frame {t}: graph {ms['graph'][-1]:.3f} ms (host "
              f"{wall['graph'][-1]:.3f}), eager {ms['eager'][-1]:.3f} ms (host "
              f"{wall['eager'][-1]:.3f}); state, render and counters bit-equal; diag {dgd}"
              + ("; the eager frame's captured part made no sync under the debug mode" if t == 1
                 else ""))
    launches = read_launches(counters)
    captured, replayed = dict(step_graph.captured), dict(step_graph.replayed)
    # Each frame: the map's kernels (eager on frame 0, replayed after) and
    # the eager step's.
    if any(n != 2 * frames for n in launches.values()) or any(
            replayed.get(fn.__name__) != frames - 1 or captured.get(fn.__name__) != 1
            for fn in counters):
        raise AssertionError(f"[graph] {name}: launches {launches} in {frames} frames of each, "
                             f"captured {captured}, replayed {replayed}")
    if set(dsp._static.graphs) != {"packed"}:
        raise AssertionError(f"[graph] {name}: graphs {list(dsp._static.graphs)}")

    t = frames
    bound_m, n_set, n_alive = movable_bound(cfg, dsp.state)
    prof = {"graph": profile_frame(lambda: graph_frame(t)),
            "eager": profile_frame(lambda: eager_frame(t))}
    parted = states_differ(dsp.state, box["state"])
    if parted:
        raise AssertionError(f"[graph] {name} profiled frame: parts in {parted}")
    api_g, kernels_g, busy_g, wall_g, n_g = prof["graph"]
    api_e, _, busy_e, wall_e, n_e = prof["eager"]
    in_graph = {}
    for key, kname in FRAME_KERNEL_NAMES:
        hits = [(ms_, n) for k, (ms_, n) in kernels_g.items() if kname in k]
        if len(hits) != 1 or hits[0][1] != 1:
            raise AssertionError(f"[graph] {name}: {kname} in the profiled replay: {hits}")
        in_graph[key] = hits[0][0]
    timed = slice(2, frames)
    med = {m: float(np.median(ms[m][timed])) for m in modes}
    med_wall = {m: float(np.median(wall[m][timed])) for m in modes}
    peak = {"graph_capture": work["graph"][1], "graph_replay": max(work["graph"][2:]),
            "eager": max(work["eager"]), "graph_pool_reserved": torch.cuda.memory_reserved()}
    objects = "eager ahead of the graph" if dsp._static.objects_eager else "in the graph"
    print(f"[graph] {name}: grid {cfg.num_voxels} voxels x K={cfg.slots_per_voxel}, image "
          f"{cfg.width}x{cfg.height}, object layer {objects}; per-frame medians over frames "
          f"2-{frames - 1}, in turns: graph {med['graph']:.3f} ms (host {med_wall['graph']:.3f}), "
          f"eager {med['eager']:.3f} ms (host {med_wall['eager']:.3f}), ratio "
          f"{med['eager'] / med['graph']:.2f}x ({card})")
    print(f"[graph] {name}: host API calls a frame: graph {api_g}, eager {api_e}; device kernels "
          f"a frame: graph {n_g}, eager {n_e}; device busy: graph {busy_g:.3f} of {wall_g:.3f} ms "
          f"({100 * busy_g / wall_g:.1f}%), eager {busy_e:.3f} of {wall_e:.3f} ms "
          f"({100 * busy_e / wall_e:.1f}%) (profiled frame {t})")
    print(f"[graph] {name}: memory a frame takes beyond the resident states: capture "
          f"{peak['graph_capture']} bytes, replay {peak['graph_replay']} bytes, eager "
          f"{peak['eager']} bytes; reserved after {peak['graph_pool_reserved']} bytes")
    print(f"[graph] {name}: kernels inside the replay (ms, profiler): "
          + ", ".join(f"{k} {v:.4f}" for k, v in in_graph.items())
          + f"; movable scan bound on this store {bound_m['bound_ms']:.4f} ms by bytes ({n_set} "
          f"slots with a status, {n_alive} alive), share "
          f"{bound_m['bound_ms'] / in_graph['movable_voxels']:.3f} ({card})")
    print(f"[graph] {name}: launches {launches} ({frames} frames each), captured {captured}, "
          f"replayed {replayed}")
    del dsp, box
    return {"graph_ms": ms["graph"], "eager_ms": ms["eager"], "graph_wall_ms": wall["graph"],
            "eager_wall_ms": wall["eager"], "median_ms": med, "median_wall_ms": med_wall,
            "api_calls": {"graph": api_g, "eager": api_e},
            "device_kernels": {"graph": n_g, "eager": n_e},
            "device_busy_ms": {"graph": busy_g, "eager": busy_e},
            "profiled_wall_ms": {"graph": wall_g, "eager": wall_e}, "memory_bytes": peak,
            "kernel_ms_in_replay": in_graph, "movable_bound": bound_m,
            "movable_slots": {"status_set": n_set, "alive": n_alive}, "objects_eager": objects, "launches": launches}


def drive_rematch(counters, card, lost=5, frames=7):
    """The VKITTI2 scene with the car's keypoints withheld on frame ``lost``,
    after the car has moved for three frames and has a velocity: the object
    layer's keypoint fit cannot run, the coast branch sets the car's
    transform to its velocity over the default interval, and the rigid move
    goes on.  Returns (launches, that frame's quantities)."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, SemanticDSPMap, virtual_kitti2_config
    from semantic_dsp_map_tpu_torch.objects import DEFAULT_PREDICT_DT

    scenes = bench_scenes()
    cfg = virtual_kitti2_config()
    dsp = SemanticDSPMap(cfg, FilterParams(**scenes.VK_PARAMS), device="cuda")
    reset_launches(counters)
    at = None
    for t in range(frames):
        # update() overwrites the map's state in place: the object table
        # before the frame is a copy.
        obj = dsp.state.objects
        before = type(obj)(**{f.name: getattr(obj, f.name).clone() for f in dataclasses.fields(obj)})
        depth, masks, pos, quat = scenes.synth_vkitti2_frame(cfg, t, MaskKpts, kpts=t != lost)
        got = frame_quantities(*dsp.update(depth, masks, pos, quat, 0.1 * t))
        obj = dsp.state.objects
        row = int(torch.nonzero(obj.valid & (obj.track_id == 3))[0])
        print(f"[rematch] frame {t}{' (no keypoints)' if t == lost else ''}: {got}; car: moving "
              f"{bool(obj.moving[row])}, window {int(obj.win_count[row])}, velocity valid "
              f"{bool(obj.vel_valid[row])}, to_match_previous {bool(obj.to_match_previous[row])}")
        if t == lost:
            at = got
            if not (bool(before.moving[row]) and bool(before.vel_valid[row])):
                raise AssertionError("rematch: the car had no velocity before it lost its keypoints")
            want = torch.eye(4, device="cuda")
            want[:3, 3] = before.velocity[row] * DEFAULT_PREDICT_DT
            if not torch.equal(obj.tmatrix[row], want) or bool(obj.to_match_previous[row]):
                raise AssertionError(f"rematch: the coast branch did not run: tmatrix {obj.tmatrix[row]}")
            if int(obj.win_count[row]) != int(before.win_count[row]):
                raise AssertionError("rematch: a keypoint fit was pushed on the frame without keypoints")
            if got["moved_count"] <= 0:
                raise AssertionError("rematch: no particle moved on the frame without keypoints")
            print(f"[rematch] frame {t}: the coast branch ran at full size: translation "
                  f"{want[:3, 3].tolist()} (velocity x {DEFAULT_PREDICT_DT} s), {got['moved_count']} "
                  f"particles moved ({card})")
    launches = read_launches(counters)
    for fname, count in launches.items():
        if count != frames:
            raise AssertionError(f"rematch: {fname} launched {count} times in {frames} frames")
    return launches, at


# ---------------------------------------------------------------------------
# Phase 5: the sharded step at one rank
# ---------------------------------------------------------------------------

def state_parting(a, b):
    """(max abs difference of the float tensors, names of the integer
    tensors that differ, all bit-equal) between two map states on the card:
    particles, voxel stamps, scroll and objects."""
    import dataclasses

    import torch

    worst, differ, bits = 0.0, [], True
    pairs = [("voxel_stamp", a.voxel_stamp, b.voxel_stamp)]
    for group in ("particles", "scroll", "objects"):
        x, y = getattr(a, group), getattr(b, group)
        pairs += [(f"{group}.{f.name}", getattr(x, f.name), getattr(y, f.name))
                  for f in dataclasses.fields(x)]
    for name, x, y in pairs:
        if x.is_floating_point():
            worst = max(worst, max_err(x, y)[0])
            bits &= torch.equal(x.view(torch.int32), y.view(torch.int32))
        elif not torch.equal(x, y):
            differ.append(name)
    return worst, differ, bits and not differ


def drive_sharded_vkitti2(counters, card, frames=8):
    """The sharded step (parallel/shard_step.py) at one rank of the default
    group, unpacked and packed, beside the single-device step, on the
    VKITTI2 preset at full width with the movers in (prediction_stddev=0.0):
    the three take each frame in turns (the order rotates frame by frame),
    each timed with CUDA events.  After every frame the two sharded states
    must equal the single-device one (integer tensors, voxel stamps and the
    nine counters bit for bit, floats within 1e-6) and so must the renders
    (occ, label, track bit for bit, weight_sum within 1e-6).  Each sharded
    call runs with the launch counts set to 0 just before it and read just
    after: the five kernels of the path must launch once a call.  Returns
    the numbers."""
    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, virtual_kitti2_config
    from semantic_dsp_map_tpu_torch.frontend import FrameInput, build_frame_input, pack_frame
    from semantic_dsp_map_tpu_torch.labels import LabelRegistry
    from semantic_dsp_map_tpu_torch.map import build_frame_step
    from semantic_dsp_map_tpu_torch.parallel.shard_step import build_shard_step
    from semantic_dsp_map_tpu_torch.parallel.sharding import gather_render, shard_state
    from semantic_dsp_map_tpu_torch.state import init_map_state

    scenes = bench_scenes()
    cfg = virtual_kitti2_config()
    params = FilterParams(**dict(scenes.VK_PARAMS, prediction_stddev=0.0))
    registry = LabelRegistry.default()
    dev = torch.device("cuda")
    steps = {"plain": build_frame_step(cfg, params, registry),
             "sharded": build_shard_step(cfg, params, registry),
             "sharded_packed": build_shard_step(cfg, params, registry, packed=True)}
    states = {"plain": init_map_state(cfg, 0, dev)}
    for name in ("sharded", "sharded_packed"):
        states[name] = shard_state(cfg, init_map_state(cfg, 0, dev), 0, 1)
    print(f"[sharded] vkitti2: grid {cfg.num_voxels} voxels x K={cfg.slots_per_voxel}, image "
          f"{cfg.width}x{cfg.height}, R={cfg.neighbor_half}: the table slab is "
          f"[{cfg.phd_pixel_table_slots}, {cfg.height + 2 * cfg.neighbor_half}, {cfg.width}]")
    ms = {name: [] for name in steps}
    launches = dict.fromkeys((fn.__name__ for fn in counters), 0)
    worst, bits, moved = 0.0, True, []
    names = list(steps)
    for t in range(frames):
        raw = (*scenes.synth_vkitti2_frame(cfg, t, MaskKpts), 0.1 * t)
        inputs = {"plain": FrameInput(*(torch.as_tensor(np.asarray(a)).to(dev)
                                        for a in build_frame_input(cfg, registry, *raw))),
                  "sharded_packed": torch.from_numpy(pack_frame(cfg, registry, *raw)).to(dev)}
        inputs["sharded"] = inputs["plain"]
        torch.cuda.synchronize()
        out = {}
        for name in names[t % 3 :] + names[: t % 3]:
            if name != "plain":
                reset_launches(counters)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out[name] = steps[name](states[name], inputs[name])
            b.record()
            torch.cuda.synchronize()
            ms[name].append(a.elapsed_time(b))
            if name != "plain":
                for fname, count in read_launches(counters).items():
                    launches[fname] += count
            states[name] = out[name][0]
        _, r1, d1 = out["plain"]
        want = {k: int(v) for k, v in d1._asdict().items()}
        moved.append(want["moved_count"])
        for name in ("sharded", "sharded_packed"):
            _, r, d = out[name]
            got = {k: int(v) for k, v in d._asdict().items()}
            if got != want:
                raise AssertionError(f"sharded vkitti2 frame {t} {name}: counters {got}, "
                                     f"single-device {want}")
            r = gather_render(r)
            for field in ("occ", "label", "track"):
                assert_equal(f"sharded vkitti2 frame {t} {name} {field}", getattr(r, field),
                             getattr(r1, field))
            err, differ, same = state_parting(states[name], states["plain"])
            err = max(err, max_err(r.weight_sum, r1.weight_sum)[0])
            if differ or err > 1e-6:
                raise AssertionError(f"sharded vkitti2 frame {t} {name}: integer tensors {differ} "
                                     f"differ, floats up to {err}")
            worst, bits = max(worst, err), bits and same and torch.equal(r.weight_sum, r1.weight_sum)
        print(f"[sharded] vkitti2 frame {t}: plain {ms['plain'][-1]:.3f} ms, sharded "
              f"{ms['sharded'][-1]:.3f} ms, packed {ms['sharded_packed'][-1]:.3f} ms (events); "
              f"equal to the single-device step; counters {want} ({card})")
    del states, out
    if not any(moved):
        raise AssertionError("sharded vkitti2: the rigid-move route moved no particle")
    for fname in launches:
        if launches[fname] != 2 * frames:
            raise AssertionError(f"sharded vkitti2: {fname} launched {launches[fname]} times in "
                                 f"{2 * frames} sharded frames")
    med = {name: float(np.median(v)) for name, v in ms.items()}
    print(f"[sharded] vkitti2 per-frame median over {frames} frames, in turns: single-device "
          f"{med['plain']:.3f} ms, sharded at one rank {med['sharded']:.3f} ms, packed "
          f"{med['sharded_packed']:.3f} ms; states bit-equal: {bits} (floats within {worst:.3e}); "
          f"moved per frame {moved}; launches {launches} ({card})")
    return {"frames": frames, "ms_median": med, "ms": ms, "bit_equal": bits,
            "max_float_err": worst, "moved_count": moved, "launches": launches}


def check_sharded_zed2(counters, card):
    """``benchmarks.bench.run_sharded_check()`` on the card: the ZED2 preset's
    static scene, 8 frames through the single-device and the sharded step in
    turns (it raises if a render parts), then a warm-up and 8 timed sharded
    frames.  The five kernels of the path must launch once a sharded frame."""
    from semantic_dsp_map_tpu_torch.benchmarks import bench

    reset_launches(counters)
    cell = bench.run_sharded_check()
    total = read_launches(counters)
    n = 2 * cell["frames"] + 1
    for fname in (fn.__name__ for fn in counters):
        if cell["kernel_launches"][fname] != n:
            raise AssertionError(f"sharded zed2: {fname} launched {cell['kernel_launches'][fname]} "
                                 f"times in {n} sharded frames")
    print(f"[sharded] zed2 ({cell['config']}): render equal to the single-device step on "
          f"{cell['frames']} frames; {1e3 * cell['sec_per_frame']:.3f} ms/frame over {cell['frames']} "
          f"timed frames (host clock, one synchronize); sharded launches {cell['kernel_launches']}, "
          f"all launches of the check {total} ({card})")
    return cell


def check_slab_kernels(report, card):
    """The five kernels of the sharded path at the shapes a rank of a D-rank
    run gives them, D in 1, 2, 4, 8, at the VKITTI2 and the ZED2 preset:
    both PHD passes over a row slab's table [S, ceil(H/D) + 2R, W], the
    render, the candidate scan and the movable scan over a z-slab of V/D
    voxels; each against
    its plain version (as in phase 2), then timed beside its bound.  The
    numbers go to ``report[kernel]["slab_shapes"]``."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, virtual_kitti2_config, zed2_config
    from semantic_dsp_map_tpu_torch.ops import observe_cuda, phd, phd_cuda
    from semantic_dsp_map_tpu_torch.ops.observe import front_candidates_plain, movable_voxels_plain
    from semantic_dsp_map_tpu_torch.ops.render import render_core_plain

    params = FilterParams(detection_probability=0.9, noise_number=0.1, if_consider_depth_noise=True)
    rows_out = {}
    for preset, cfg in (("vkitti2", virtual_kitti2_config()), ("zed2", zed2_config())):
        for D in (1, 2, 4, 8):
            tag = f"{preset}_D{D}"
            rows = -(-cfg.height // D) + 2 * cfg.neighbor_half
            t, cloud, _ = phd_inputs(cfg, seed=D, rows=rows)
            a_args = pass_a_inputs(cfg, params, t, cloud, torch.where(t.meta >= 0, t.weight, 0.0))
            ck, (a_abs, _) = check_pass_a(f"slab {tag}", a_args)
            b_a = pass_a_bound(a_args, ck, pass_a_census(a_args))[0]
            row_a = {"table": list(t.px.shape), "max_abs_err": a_abs,
                     "ms": cuda_ms(lambda: phd_cuda.pass_a_cuda(*a_args), 10),
                     "plain_ms": cuda_ms(lambda: phd.pass_a_raw(*a_args), 3), **b_a}
            b_args = pass_b_inputs(cfg, params, t, cloud, phd.stencil_pass_a(cfg, params, t, cloud))
            acc, right, (b_abs, _), _ = check_pass_b(f"slab {tag}", b_args)
            row_b = {"table": list(t.px.shape), "max_abs_err": b_abs,
                     "ms": cuda_ms(lambda: phd_cuda.pass_b_cuda(*b_args), 10),
                     "plain_ms": cuda_ms(lambda: phd.pass_b_raw(*b_args), 3),
                     **pass_b_bound(b_args, acc, right)[0]}
            del t, cloud, a_args, b_args, ck, acc, right

            vcfg = dataclasses.replace(cfg, voxel_num_axis_z_n=cfg.voxel_num_axis_z_n - int(np.log2(D)))
            p, vst, vax = random_render_state(vcfg, seed=D)
            pk, r_k, (e1, e2), _ = check_render_once(f"slab {tag}", vcfg, p, vst, vax, 0.4)
            run_r, restore = render_runner(vcfg, p, vst, vax, 0.4)
            row_r = {"voxels": vcfg.num_voxels, "max_abs_err": max(e1, e2),
                     "ms": cuda_ms(run_r, 10, setup=restore),
                     "plain_ms": cuda_ms(lambda: render_core_plain(vcfg, p, vst, vax, 0.4), 3),
                     **render_census(vcfg, p, pk, vax, vst, r_k)["bound"]}
            del p, pk, r_k, run_r, restore
            fargs, p, vax = observe_inputs(vcfg)
            ha_p, hc_p = front_candidates_plain(*fargs)
            ha_k, hc_k = observe_cuda.front_candidates_cuda(*fargs)
            torch.cuda.synchronize()
            assert_equal(f"slab {tag} front has_alive", ha_k, ha_p)
            assert_equal(f"slab {tag} front has_cand", hc_k, hc_p)
            row_f = {"voxels": vcfg.num_voxels, "max_abs_err": 0.0,
                     "ms": cuda_ms(lambda: observe_cuda.front_candidates_cuda(*fargs), 10),
                     "plain_ms": cuda_ms(lambda: front_candidates_plain(*fargs), 3),
                     **front_bound(fargs, ha_k, hc_k)[0]}
            n_alive = front_bound(fargs, ha_k, hc_k)[1]
            margs = (vcfg, p.track, p.status, p.stamp, vax, 1)
            hm_p = movable_voxels_plain(*margs)
            hm_k = observe_cuda.movable_voxels_cuda(*margs)
            torch.cuda.synchronize()
            assert_equal(f"slab {tag} movable", hm_k, hm_p)
            row_m = {"voxels": vcfg.num_voxels, "max_abs_err": 0.0,
                     "ms": cuda_ms(lambda: observe_cuda.movable_voxels_cuda(*margs), 10),
                     "plain_ms": cuda_ms(lambda: movable_voxels_plain(*margs), 3),
                     **bound(nbytes(p.status, p.stamp, vax, hm_k) + 4 * n_alive)}
            del fargs, margs, p, vax
            torch.cuda.empty_cache()
            for key, row in (("phd_pass_a", row_a), ("phd_pass_b", row_b), ("render", row_r),
                             ("front_candidates", row_f), ("movable_voxels", row_m)):
                report[key].setdefault("slab_shapes", {})[tag] = row
                shape = row.get("table") or f"{row['voxels']} voxels"
                print(f"[slab] {tag} {key} {shape}: equal to the plain version (max abs "
                      f"{row['max_abs_err']:.3e}); kernel {row['ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
                      f"({card})")
            rows_out[tag] = {"phd_pass_a": row_a, "phd_pass_b": row_b, "render": row_r,
                             "front_candidates": row_f, "movable_voxels": row_m}
    return rows_out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels"), default="all",
                    help="'kernels' stops after the per-kernel checks")
    ap.add_argument("--profile", action="store_true",
                    help="after each main path, profile 3 more frames (traces in chiprun_out/)")
    ap.add_argument("--against", metavar="DIR", type=Path,
                    help="a directory holding another version of csrc/'s sources: both PHD "
                         "passes, the render, the candidate scan and the gather are also built "
                         "from it and timed in turns with the package's own, on the checked "
                         "inputs and (the first four) on the real frame")
    ap.add_argument("--record-expected", action="store_true",
                    help="print where the card parts from data/bench_expected instead of "
                         "failing (its values go to chiprun_out/EXPECTED_CARD.json either way)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this smoke run needs one",
              file=sys.stderr)
        return 2
    if not (REPO / "semantic_dsp_map_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: semantic_dsp_map_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from semantic_dsp_map_tpu_torch import (
        FilterParams, coda_config, tiny_test_config, virtual_kitti2_config, zed2_config,
    )
    from semantic_dsp_map_tpu_torch.config import KEYPOINTS_BBOX3D
    from semantic_dsp_map_tpu_torch import profiling, step_graph
    from semantic_dsp_map_tpu_torch.ops import cuda_lib, probes_cuda
    from semantic_dsp_map_tpu_torch.timing import card_line

    card = card_line(torch.device("cuda"))
    print(f"[card] nvidia-smi: {card}")
    print(f"[card] torch: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    path, build_s, log = cuda_lib.build()
    print(f"[build] {path.relative_to(REPO)} in {build_s:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "error" in line.lower():
            print(f"[build] {line.strip()}")

    scenes = bench_scenes()
    vk_cfg, zed2_cfg, coda_cfg = virtual_kitti2_config(), zed2_config(), coda_config()
    source = "semantic_dsp_map_tpu_torch/csrc/"
    report = {
        "phd_pass_a": dict(name="phd_pass_a", route="cuda", source=source + "phd.cu",
                           replaces="semantic_dsp_map_tpu/ops/phd_pallas.py:119"),
        "phd_pass_b": dict(name="phd_pass_b", route="cuda", source=source + "phd.cu",
                           replaces="semantic_dsp_map_tpu/ops/phd_pallas.py:269"),
        "render": dict(name="render", route="cuda", source=source + "render.cu",
                       replaces="semantic_dsp_map_tpu/ops/render_pallas.py:71"),
        "front_candidates": dict(name="front_candidates", route="cuda",
                                 source=source + "observe.cu",
                                 replaces="semantic_dsp_map_tpu/ops/observe_pallas.py:56"),
        "movable_voxels": dict(name="movable_voxels", route="cuda", source=source + "observe.cu",
                               replaces="semantic_dsp_map_tpu/ops/observe_pallas.py:104"),
        "gather": dict(name="gather", route="cuda", source=source + "probes.cu",
                       replaces="benchmarks/prim_bench7.py:28"),
        "scale2": dict(name="scale2", route="cuda", source=source + "probes.cu",
                       replaces="benchmarks/prim_bench1.py:63"),
    }
    # No single PyTorch call computes a frame kernel's function.
    for key in ("phd_pass_a", "phd_pass_b", "render", "front_candidates", "movable_voxels"):
        report[key]["library_ms"] = None
    # ms / plain_ms / max_abs_err at VKITTI2 shapes, zed2_* at ZED2 shapes,
    # coda_* at the coda preset's (960 x 540, K = 3 at 8.4M voxels)
    for cfg, prefix in ((vk_cfg, ""), (zed2_cfg, "zed2_"), (coda_cfg, "coda_")):
        check_phd(cfg, report, prefix)
        check_render(cfg, report, prefix)
        check_observe(cfg, report, prefix)
    check_probes(report)
    check_launch(report, card)
    torch.cuda.empty_cache()
    other, against = None, {}
    if args.against is not None:
        other_path, other_s, _ = cuda_lib.build(args.against.resolve())
        print(f"[against] {args.against} built into {other_path.relative_to(REPO)} in {other_s:.1f} s")
        other = cuda_lib.load(other_path)
        for cfg, label in ((vk_cfg, "vkitti2 shapes"), (zed2_cfg, "zed2 shapes")):
            against[label] = compare_versions(other, cfg, label, card)
        against["gather"] = compare_gather(other, card)
        torch.cuda.empty_cache()
    if args.phase == "kernels":
        print(json.dumps({"kernels": list(report.values())}))
        print(f"[card] {card}")
        return 0

    fns = step_graph.FRAME_KERNELS
    counters = {key: fn for (key, _), fn in zip(FRAME_KERNEL_NAMES, fns, strict=True)}
    check_scene_cuda_vs_cpu("dynamic scene", tiny_test_config(), FilterParams(**TINY_PARAMS),
                            tiny_scene, fns)
    for independent in (False, True):
        check_scene_cuda_vs_cpu(
            f"ZED2 scene independent={independent}",
            tiny_test_config(keypoint_mode=KEYPOINTS_BBOX3D),
            FilterParams(**TINY_ZED2_PARAMS, if_use_independent_filter=independent),
            tiny_zed2_scene, fns,
        )
    check_template_scene(fns)
    check_scene_cuda_vs_cpu(
        "reduced hostile scene", virtual_kitti2_config(**scenes.REDUCED_VKITTI2),
        FilterParams(**dict(scenes.VK_PARAMS, prediction_stddev=0.0)), reduced_hostile_scene, fns,
        frames=6)
    smoothed_ms = {"vkitti2": check_smoothed_render(vk_cfg, "vkitti2", against_cpu=False),
                   "zed2": check_smoothed_render(zed2_cfg, "zed2")}
    torch.cuda.empty_cache()

    expected = check_expected(fns, card, record=args.record_expected)
    torch.cuda.empty_cache()
    bench_cells, bench_launches = run_bench(fns, card)
    torch.cuda.empty_cache()

    paths = (("vkitti2", vk_cfg, scenes.VK_PARAMS, scenes.synth_vkitti2_frame, None),
             ("zed2", zed2_cfg, scenes.ZED2_PARAMS, scenes.synth_zed2_frame, None),
             ("vkitti2_template", vk_cfg, scenes.TPL_PARAMS, scenes.synth_template_frame,
              TEMPLATES),
             ("coda", coda_cfg, scenes.CODA_PARAMS, scenes.synth_coda_frame, None))
    medians, template, real_frame = {}, {}, {}
    for name, cfg, params, synth, tpl_path in paths:
        launches, medians[name], dsp, frame_ms, sweeps = drive_main_path(
            name, cfg, FilterParams(**params), synth, fns, card, template_path=tpl_path)
        if name == "vkitti2":
            real_frame = check_real_frame(dsp, synth, len(frame_ms), card, other)
        if tpl_path is not None:
            births = [(t, sw, n) for t, sw, n in sweeps if sw.stage == "birth"]
            if not births:
                raise AssertionError(f"{name}: no template birth was attempted")
            t_birth, sw, guessed = births[0]
            if guessed == 0:
                raise AssertionError(f"{name}: the template birth made no GUESSED_BORN particle")
            sweep_ms, score = time_template_sweep(dsp, synth, t_birth)
            if score != float(sw.score):
                raise AssertionError(f"{name}: the sweep alone scored {score}, the path {float(sw.score)}")
            template = dict(birth_frame=t_birth, gate_row=sw.gate_row.tolist(), score=score,
                            guessed_born=guessed, birth_frame_ms=frame_ms[t_birth],
                            sweep_ms=sweep_ms, sweeps=len(sweeps))
            print(f"[{name}] birth on frame {t_birth}: frame {frame_ms[t_birth]:.3f} ms, the sweep "
                  f"alone {sweep_ms:.3f} ms (score {score:.6f}), {guessed} GUESSED_BORN ({card})")
        if args.profile:
            profile_main_path(dsp, synth, card)
        del dsp
        for key, fn in counters.items():
            report[key].setdefault("launches_by_path", {})[name] = launches[fn.__name__]
    torch.cuda.empty_cache()

    graph = {}
    for name, cfg, params, synth in (
            ("vkitti2", vk_cfg, scenes.VK_PARAMS, scenes.synth_vkitti2_frame),
            ("zed2", zed2_cfg, scenes.ZED2_PARAMS, scenes.synth_zed2_frame),
            ("coda", coda_cfg, scenes.CODA_PARAMS, scenes.synth_coda_frame),
            ("vkitti2_hostile", vk_cfg, scenes.VK_PARAMS, scenes.synth_hostile_frame)):
        graph[name] = drive_graph(name, cfg, FilterParams(**params), synth, fns, card)
        torch.cuda.empty_cache()
        for key, fn in counters.items():
            report[key].setdefault("graph_ms_by_path", {})[name] = (
                graph[name]["kernel_ms_in_replay"][key])
            report[key]["launches_by_path"]["graph_" + name] = graph[name]["launches"][fn.__name__]
    for key in counters:
        report[key]["graph_ms"] = report[key]["graph_ms_by_path"]["vkitti2"]

    rematch_launches, rematch_frame = drive_rematch(fns, card)
    replay_launches, replay_ms = drive_replay(fns, card)
    soak_launches, soak_report = drive_soak(fns, card)
    for key, fn in counters.items():
        by_path = report[key]["launches_by_path"]
        by_path["rematch"] = rematch_launches[fn.__name__]
        by_path["replay"] = replay_launches[fn.__name__]
        by_path["kitti360_soak"] = soak_launches[fn.__name__]
        by_path["bench"] = bench_launches[fn.__name__]
        for name, summary in expected.items():
            by_path["expected_" + name] = summary["launches"][fn.__name__]
        report[key]["launches"] = report[key]["launches_by_path"]["vkitti2"]
    torch.cuda.empty_cache()

    print(f"[profiling] the stage profiler at vkitti2, 3 frames per prefix ({card})")
    stage_rows = profiling.main(["--config", "vkitti2", "--iters", "3"])
    torch.cuda.empty_cache()

    probe_counters = {"gather": probes_cuda.gather_cuda, "scale2": probes_cuda.scale2_cuda}
    probe_launches, probe_rows = run_probe_modules(tuple(probe_counters.values()), card)
    for key, fn in probe_counters.items():
        report[key]["launches"] = probe_launches[fn.__name__]
        report[key]["launches_by_path"] = {"probes": probe_launches[fn.__name__]}

    # Phase 5: the sharded step at one rank, in a process group of this
    # process alone (NCCL on the card), then the kernels at slab shapes and
    # the weak-scaling report at one rank.
    import torch.distributed as dist
    from semantic_dsp_map_tpu_torch.parallel import distributed

    distributed.initialize()
    print(f"[sharded] process group: {dist.get_backend()}, {dist.get_world_size()} rank ({card})")
    sharded = {"vkitti2": drive_sharded_vkitti2(fns, card)}
    torch.cuda.empty_cache()
    sharded["zed2"] = check_sharded_zed2(fns, card)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    sharded["slab_shapes"] = check_slab_kernels(report, card)
    print(f"[sharded] the weak-scaling report at one rank ({card})")
    sharded["weak_scaling"] = distributed.main(["--devices", "1", "--preset", "medium"])
    for key, fn in counters.items():
        by_path = report[key]["launches_by_path"]
        by_path["sharded_vkitti2"] = sharded["vkitti2"]["launches"][fn.__name__]
        by_path["sharded_zed2"] = sharded["zed2"]["kernel_launches"][fn.__name__]

    print(json.dumps({"kernels": list(report.values()), "frame_ms_median": medians,
                      "template": template, "smoothed_render_ms": smoothed_ms,
                      "real_frame": real_frame, "against": against,
                      "replay_ms_per_frame": replay_ms, "soak": soak_report,
                      "stage_profile": stage_rows, "probes": probe_rows, "bench": bench_cells,
                      "expected": expected, "rematch_frame": rematch_frame, "sharded": sharded,
                      "graph": graph,
                      "card": card}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
