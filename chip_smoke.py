#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # all phases, as a check of a checkout
    python3 chip_smoke.py --phase kernels   # build + per-kernel checks only
    python3 chip_smoke.py --phase graph     # build + [graph] only
    python3 chip_smoke.py --phase sharded   # build + [sharded]'s vkitti2 and zed2 runs only
    python3 chip_smoke.py --phase scan      # build + [scan] only (the sharded part too)
    python3 chip_smoke.py --phase merge     # build + [merge] only (the sharded part too)
    python3 chip_smoke.py --phase k31       # build + [k31] only
    python3 chip_smoke.py --phase visible   # build + [visible] only
    python3 chip_smoke.py --phase wide      # build + [wide] only (the sharded K = 63 step too)
    python3 chip_smoke.py --phase templates # build + [templates] only (the template kernels)
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
  2. check each of the eight kernels against its plain PyTorch version on
     the card and time both with CUDA events, beside the kernel's bound
     (bytes over the memory rate or operations over their peak rate,
     whichever is larger, from this run's inputs): the five frame kernels at
     VKITTI2 shapes, at ZED2 shapes (BOOST 640x360, R = 3, K = 3) and at the
     coda preset's (960x540, K = 3 at 8.4M voxels), the
     gather and x2 probe kernels at the probes' shapes, in turns with the
     PyTorch call that computes the same function (the gather also with its
     indices sorted); the movable scan also a launch inside a CUDA graph
     (no host time), its bound (``movable_bound``) printed once beside the
     two reckonings it replaced; birth's merge (csrc/birth.cu) at the VKITTI2 birth,
     the VKITTI2 moving-object cleanup and the ZED2 birth working sets on
     the presets' full stores, bit for bit, ms, device-only ms, the bound
     and its share; then [launch]: each of the eight
     wrappers' host time
     per launch beside the bare ctypes call of its entry point and beside
     torch.mul;
  3. check the CUDA path against the CPU path on the tiny dynamic scene, on
     the tiny ZED2 scene (independent filter off and on), on the small
     template scene (a template birth fires) and on the reduced hostile
     scene (20 movers, the move cap binding), every kernel on; and the
     neighbour-smoothed render on a random state, against the CPU at ZED2
     shapes and timed on the card at VKITTI2 and ZED2 shapes;
  3k. [k31]: a store of 31 slots a voxel (``max_particle_num_per_voxel_n``
     5, the largest K of the kernels' main instances) at the reduced
     VKITTI2 grid: the reduced hostile scene through update() on two maps on
     the card in turns, one with the four per-voxel kernels and one with
     their plain versions, bit-equal every frame and every kernel counted;
     the four kernels on that map's store against their plain versions,
     timed;
  3w. [wide]: the stores and stencils past the main instances, which the
     kernels' generic (K > 31) and wide (pass A past R = 13, pass B past its
     shared memory) instances run.  (a) The full VKITTI2 grid at K = 63
     (528,482,304 slots, a 14.3 GB store): 6 frames of the vkitti2 scene
     with its noise on through update(), each kernel's launches counted;
     then on the map's store after one more (eager) frame the render, the
     front and movable scans, birth's merge in both instances on the
     frame's two working sets, and both PHD passes against their plain
     versions on the card, each timed with its bound and share, and the
     peak memory.  (b) The reduced grid at K = 63 and 127: the two maps of
     [k31] in turns, bit-equal every frame, and the four kernels on the
     store (the merge in both instances), each with its bound and share
     (the render's census: the valid voxels with a status its generic
     instance reads, a warp a voxel); in [sharded]'s process
     group, the captured sharded step at K = 63 against the eager one, 3
     frames bit-equal.  (c) A real VKITTI2 frame's pixel table through
     passes A and B at R = 9, 12 and 16, and a VKITTI2 map's at S = 512,
     against the plain stencils (floats within rtol 2e-5 / atol 1e-6, flags
     equal away from the threshold), each timed with its bound; at S = 512
     the two live-plane passes that run before a wide instance, against
     ops.phd.live_planes; pass A wide on a full S = 512 table; each pass's
     first wide shape beside the main one just below it (S = 67 / 68 and
     R = 12 / 13 for pass A, S = 431 / 432 for pass B, whose shared planes
     must be bit-equal), timed a term; the S = 512 map through update()
     against the eager step, 4 frames bit-equal, each PHD kernel once a
     frame; then 4 VKITTI2 frames at R = 12 through update();
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
     frames; check that every frame kernel ran once per frame, the merge
     kernel once per ``_insert_core``, and that the
     template birth swept, scored and made guessed particles; time the
     birth's sweep alone.  After the vkitti2 frames, one more frame's own
     pixel table, cloud and particle store go through both PHD passes, the
     candidate scan and the render alone (against their plain versions, then
     timed), and its two merges' working sets through the merge kernel: a
     frame's data is patchy and mostly empty where the checked inputs are
     uniform.  Then the rematch path: the VKITTI2 scene with
     the car's keypoints withheld on frame 5, where the object layer's coast
     branch must run at full size.  Then the
     replay path: 13 VKITTI2 frames written
     as npz files and replayed by ``replay.main`` on the default device
     (11 mapped frames, PLY clouds read back); the KITTI-360 soak
     (``tools.soak``: the largest preset, a checkpoint and a restore); the
     stage profiler's table at VKITTI2; and the two primitive-op probe
     modules, which launch the gather and x2 kernels;
  4b. [graph]: the captured step against the eager one at full width on
     vkitti2, zed2, coda, the hostile scene and vkitti2_template:
     SemanticDSPMap.update() (frame 0 eager, frame 1 captured into CUDA
     graphs, replays after: at zed2 one graph, at the superpoint four two
     graphs around the refit's eager SVD) in turns with build_frame_step on
     a state of its own, 10 frames, noise on: state (generator included),
     render and counters bit-equal every frame, and in template mode the
     sweep records too.  vkitti2_template's car first shows on frame 2 (the
     birth branch, a conditional node, runs in a replay) and loses its
     keypoints on frame 5 (the rematch branch); no branch runs on the other
     frames.  Both per-frame medians, the SVD bridge's host and device ms,
     host API calls a frame (by name), device busy share, the memory a frame
     takes, the five kernels' device time inside a replay
     (torch.profiler) and the top 15 ops of the replayed frame by device ms
     with their launches, and in template mode a replay's device time with
     a taken branch.  Every main path's map replays its
     graph; a path's launch counts are a wrapper's launches outside graphs
     plus those captured into a graph times its replays
     (step_graph.kernel_runs).  On every path the script drives, each frame
     kernel runs once a frame and birth's merge once per ``_insert_core``:
     twice a frame (birth, the moving-object cleanup), four times with a
     template bank (``inserts_a_frame``);
  4c. [scan]: the segment scans (ops/blocks.py: segment_start_index,
     group_rank, segment_cumsum) against the torch.cummax form the port
     used before, written out here as the plain reference.  First the
     frames, old against new: at vkitti2, zed2 and the hostile scene,
     noise on, two maps fed
     the same 10 frames in turns, one built as the package builds it and
     one whose every frame runs with the modules that bind the scans
     (ops.blocks, ops.observe, ops.birth, parallel.shard_step) holding the
     cummax form (patched here only, inside the map's calls): bit-equal
     every frame (state, generator, render, counters); update() medians,
     the medians of 10 loops of 8 frames each with one synchronize a loop
     (new, cummax, cummax, new, five times), device busy, host API calls and the top 15 ops of one profiled
     replayed frame of each.  Then the primitives at every length those
     frames ran them at and at 58,720,256: integers equal at start
     densities 0 to 1, eagerly and (below 58.7M) in a CUDA graph; times
     with CUDA events beside the cummax form, torch.cumsum on the same
     length and the bytes' bound at 3.35 TB/s.  In [sharded], the same
     old-against-new pair on the captured sharded step at one rank;
  4d. [merge]: birth's block merge, the kernel of csrc/birth.cu against
     its plain version: at vkitti2, zed2, the hostile scene and
     vkitti2_template ([graph]'s scene: the birth branch on frame 2, the
     rematch branch on frame 5), noise on, two maps fed the same 10 frames
     in turns, one built as the package builds it and one whose every
     frame runs with ``merge_blocks_plain`` patched into ``ops.birth`` (here
     only, inside the map's calls): bit-equal every frame (state,
     generator, render, counters, sweep records); ``update()`` medians, 4
     loops of 8 frames each, one profiled replay of each (device busy,
     kernels, host API calls, the top 15 ops); the merge kernel ran once
     per ``_insert_core`` call (counted in every module that binds it) and
     only in the kernel map.  In [sharded], the same pair of captured
     sharded steps at one rank;
  4e. [visible]: the JAX package's VisibleSet surface and
     ``insert_particles`` at full width: a VKITTI2 map (the default preset,
     1242 x 375, S = 12, R = 5, 8,388,608 voxels, K = 7) driven three frames
     of the vkitti2 scene; on frame 3's cloud, (a) ``compute_ck_kappa`` and
     ``phd_weight_update`` over the VisibleSet of every live slot of the
     store in view (a tenth marked invisible, padding past the real
     entries) with both CUDA passes against the plain stencils on the card,
     each update on a copy of the store: floats within the tolerance,
     status and stamp equal, forget counts equal away from the flag's
     threshold, the passes' launches counted (A twice, B once), each pass
     timed beside its bound; (b) ``insert_particles`` of the frame's newborn
     candidates with the merge kernel's acceptance instance against
     ``merge_blocks_plain`` on the card and against the count-only
     instance: stores bit-equal, ``accepted`` equal, its sum the count; the
     two instances timed in turns beside the bound;
  5. [sharded]: the sharded step (parallel/shard_step.py) at one rank, in a
     process group of this process alone (NCCL): at the VKITTI2 preset with
     the movers, 8 frames, four ways in turns, timed with CUDA events: the
     single-device eager step, the eager sharded step (the oracle), and the
     captured sharded step (``build_shard_step``: frame 0 eager, frame 1
     captured, replays of graphs "fit" and "finish" around the eager SVD
     after) unpacked and packed; the captured ways bit-equal to the oracle
     every frame (state, both generators, render, counters), the oracle
     equal to the single-device step (integer state, voxel stamps, the
     render and the counters bit for bit, floats within 1e-6); per-frame
     medians, host API calls a frame by name, device busy share, the
     bridge's host and device ms and the memory a capture takes; then 6
     frames with the noise on, the captured ways against the oracle bit for
     bit; at the ZED2 preset, ``benchmarks.bench.run_sharded_check``, whose
     sharded step replays graph "step"; PHD passes A and B, the render, the
     candidate scan and the movable scan run once a sharded frame, birth's
     merge twice (``step_graph.kernel_runs``).  Then those five kernels against their
     plain versions at the shapes a rank of a D-rank run gives them (D = 1,
     2, 4, 8; VKITTI2 and ZED2), and the weak-scaling report at one rank
     (both sides captured).
Then one JSON line with the kernels' numbers, the card again, and as the
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the package beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

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
    entry and valid observation pixel of its window; what these inputs need
    read once: the track of every entry, the position and forgetting factor
    (16 B) only of the occupied ones (an empty entry's decide nothing, and
    counting every entry's put the bound above the kernel's time at
    S = 512), the observation planes; every output written once."""
    cfg, _, px, py, pz, trk_eff, ff_eff, isg, ox, oy, oz, valid, otrk, ck = args
    occupied = (trk_eff != -2).sum(0).double()
    terms = int((occupied * window_counts(valid, cfg.neighbor_half)).sum())
    n = nbytes(trk_eff, isg, ox, oy, oz, valid, otrk, ck, acc, right) + 16 * int(occupied.sum())
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
    # the generic instance (K past 31) reads the valid voxels with a status
    # set, a warp a voxel: how many, and their alive slots
    listed = has_status.view(-1, K).any(1) & (vst != 0) & (vst >= vax)
    per = alive.view(-1, K).sum(1)[listed]
    c.update(voxels_with_status=int(has_status.view(-1, K).any(1).sum()),
             listed_voxels=int(listed.sum()),
             alive_per_listed_mean=float(per.float().mean()) if per.numel() else 0.0,
             alive_per_listed_max=int(per.max()) if per.numel() else 0)
    fixed = nbytes(p.status, vax, vst, r.occ, r.label, r.track, r.weight_sum)
    c["bound"] = bound(fixed + 4 * c["with_status"] + 9 * c["alive"] + 4 * c["clamped"] + c["collected"])
    c["bound_every_stamp"] = bound(fixed + nbytes(p.stamp) + 9 * c["alive"] + 4 * c["clamped"]
                                   + c["collected"])["bound_ms"]
    c["bound_all"] = bound(nbytes(p.weight, p.stamp, p.status, p.track, p.label, vax, vst,
                                  pk.weight, pk.status, r.occ, r.label, r.track, r.weight_sum))["bound_ms"]
    return c


def census_line(c) -> str:
    return (f"{c['with_status']} of {c['slots']} slots with a status, {c['alive']} alive, {c['clamped']} "
            f"weights clamped, {c['collected']} slots collected; {c['voxels_with_status']} voxels "
            f"with a status, {c['listed_voxels']} of them valid ({c['alive_per_listed_mean']:.2f} "
            f"alive slots each, at most {c['alive_per_listed_max']}); {c['spans_without_status']} of "
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
    # Bounds from this store (front_bound, movable_bound); beside the
    # movable scan's, the two reckonings it replaced: every slot's stamp
    # read (phase 2 before), every voxel's scroll stamp read ([graph] before).
    b_f, n_alive, (b_f_stamps, b_f_all) = front_bound(args, ha_k, hc_k)
    b_m, n_set, _, n_vox = movable_bound(cfg, p.status, p.stamp, vax)
    old_m = {"every_stamp": bound(nbytes(p.status, p.stamp, vax, hm_k) + 4 * n_alive)["bound_ms"],
             "every_voxel_stamp": bound(nbytes(p.status, vax, hm_k) + 4 * (n_set + n_alive))[
                 "bound_ms"]}
    note_f = cache_note(report["front_candidates"], prefix, *args[1:])
    note_m = cache_note(report["movable_voxels"], prefix, p.track, p.status, p.stamp, vax)
    print(f"[observe] {prefix}{n_alive} of {n} slots alive; bounds: front "
          f"{b_f['bound_ms']:.4f} ms (every slot's stamp read: {b_f_stamps:.4f} ms; all {n} "
          f"slots' positions too: {b_f_all:.4f} ms){note_f}, "
          f"movable {b_m['bound_ms']:.4f} ms ({n_set} slots and {n_vox} voxels with a status; "
          f"the old reckonings: every slot's stamp read {old_m['every_stamp']:.4f} ms, every "
          f"voxel's scroll stamp read {old_m['every_voxel_stamp']:.4f} ms; all tracks read too: "
          f"{bound(nbytes(p.track, p.status, p.stamp, vax, hm_k))['bound_ms']:.4f} ms){note_m}, "
          f"by bytes")
    report["front_candidates"].update(
        {prefix + "max_abs_err": 0.0, prefix + "ms": ms_f, prefix + "queued_ms": q_f,
         prefix + "plain_ms": ms_f_plain,
         **{prefix + k: v for k, v in b_f.items()}})
    report["movable_voxels"].update(
        {prefix + "max_abs_err": 0.0, prefix + "ms": ms_m, prefix + "queued_ms": q_m,
         prefix + "plain_ms": ms_m_plain, prefix + "in_graph_ms": g_m,
         prefix + "old_bounds_ms": old_m, **{prefix + k: v for k, v in b_m.items()}})


#: The merge kernel's checked shapes (csrc/birth.cu): (label, preset,
#: target rows A, real rows, resample).  vkitti2: birth at the VKITTI2
#: preset (max_birth_blocks = 1536 rows of 64 voxels, K = 7); vkitti2_move:
#: the moving-object cleanup's insert there (2 x max_moving_blocks = 256
#: rows); zed2: birth at the ZED2 preset (1024 rows of 128 voxels, K = 3).
#: Some rows are padding, as where fewer blocks are targeted.
MERGE_SHAPES = (("vkitti2", "vkitti2", 1536, 1400, True),
                ("vkitti2_move", "vkitti2", 256, 200, False),
                ("zed2", "zed2", 1024, 1000, True))


def merge_inputs(cfg, A, n_real, seed=0):
    """Random inputs of birth's merge on the card at ``cfg``'s store size:
    the store's nine fields (statuses mostly UPDATED, a tenth of the voxels
    with weights near 1e-4, whose resample wipes), the voxels' scroll
    stamps (some slots stale), ``A`` rows of which the first ``n_real`` are
    real (ascending unique block ids, then the padding ids nb + row) and 0
    to K staged candidates a voxel.  Returns (flat, blocks, vox_axis,
    staged)."""
    import torch
    from semantic_dsp_map_tpu_torch.ops.birth import Staged
    from semantic_dsp_map_tpu_torch.ops.blocks import ActiveBlocks, block_layout
    from semantic_dsp_map_tpu_torch.state import Particles

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    K, V = cfg.slots_per_voxel, cfg.num_voxels
    bv, nb, _spb = block_layout(cfg)
    n = V * K
    r = lambda *shape: torch.rand(shape, generator=gen, device="cuda")
    ri = lambda hi, *shape: torch.randint(0, hi, shape, generator=gen, device="cuda",
                                          dtype=torch.int32)
    cut = lambda x, edges: torch.bucketize(x, torch.tensor(edges, device="cuda"))
    scale = torch.where(r(V) < 0.1, 1e-4, 0.6).repeat_interleave(K)
    flat = Particles(
        px=torch.randn(n, generator=gen, device="cuda"),
        py=torch.randn(n, generator=gen, device="cuda"),
        pz=torch.randn(n, generator=gen, device="cuda"),
        weight=r(n) * scale, label=ri(256, n).to(torch.uint8), track=ri(65536, n),
        status=cut(r(n), [0.15, 0.85, 0.95]).to(torch.uint8), forget=ri(8, n).to(torch.uint8),
        stamp=ri(8, n))
    vax = cut(r(V), [0.8, 0.95]).to(torch.int32)
    ids = nb + torch.arange(A, device="cuda")
    ids[:n_real] = torch.sort(torch.randperm(nb, generator=gen, device="cuda")[:n_real]).values
    blocks = ActiveBlocks(ids=ids, count=torch.tensor(n_real, device="cuda"),
                          overflow=torch.zeros((), dtype=torch.int64, device="cuda"))
    n_staged = torch.randint(0, K + 1, (A, bv, 1), generator=gen, device="cuda")
    n_staged[n_real:] = 0
    occ = torch.arange(K, device="cuda") < n_staged
    meta = (ri(8, A, bv, K) << 27) | (ri(8, A, bv, K) << 24) | (ri(256, A, bv, K) << 16) | ri(
        65536, A, bv, K)
    zero = lambda x: torch.where(occ, x, torch.zeros_like(x))
    staged = Staged(
        *(zero(torch.randn((A, bv, K), generator=gen, device="cuda")) for _ in range(3)),
        zero(r(A, bv, K)), zero(ri(8, A, bv, K) + 1), torch.where(occ, meta, -1))
    return flat, blocks, vax, staged


def merge_bound(cfg, blocks, staged, before, after, resample, accepted):
    """The merge's bound on these inputs: what the function must move at
    the memory rate, counted from this run's data.  Read: each real row's
    slots' status, stamp and staged meta (9 B a slot), with ``resample``
    the weights of every voxel that has a staged candidate (4 B a slot),
    the staged position, weight and stamp of each accepted candidate (20
    B), the real voxels' scroll stamps (4 B), every row's block id (8 B).
    Written: each element of the store that changed from ``before`` to
    ``after`` (the plain version's result), at its size, and the count
    (8 B).  Returns (bound, real rows)."""
    import torch
    from semantic_dsp_map_tpu_torch.ops.blocks import block_layout

    bv, _, spb = block_layout(cfg)
    nb = before["status"].numel() // spb  # the store's blocks (a cut store has fewer)
    A = blocks.ids.shape[0]
    real = blocks.ids < nb
    n_real = int(real.sum())
    read = n_real * spb * 9 + 20 * int(accepted) + 4 * n_real * bv + 8 * A
    if resample:
        targets = int(((staged.meta >= 0).any(dim=2) & real[:, None]).sum())
        read += 4 * cfg.slots_per_voxel * targets
    written = 8
    for name, old in before.items():
        new = getattr(after, name)
        if new.dtype == torch.float32:
            new, old = new.view(torch.int32), old.view(torch.int32)
        written += int((new != old).sum()) * new.element_size()
    return bound(read + written), n_real


def check_merge_once(tag, cfg, flat, blocks, vax, staged, resample, card, reps=10,
                     accepted=False):
    """The merge kernel against merge_blocks_plain on the same inputs (each
    on a copy of the store: both work in place): the store's bits and the
    count equal.  With ``accepted`` its acceptance instance
    (``merge_blocks_accepted_cuda``) against ``merge_blocks_plain(...,
    want_accepted=True)``, the per-candidate mask equal too, its bytes in
    the bound.  Then both timed with CUDA events, each launch on the store
    as it was (restored outside the events), the kernel also with its
    launch queued (device-only).  The store ``flat`` is left as it came.
    Returns the numbers."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch.ops.birth import merge_blocks_plain
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import (
        merge_blocks_accepted_cuda, merge_blocks_cuda,
    )

    fields = [f.name for f in dataclasses.fields(flat)]
    keep = {k: getattr(flat, k).clone() for k in fields}
    work = type(flat)(**{k: v.clone() for k, v in keep.items()})
    kernel = merge_blocks_accepted_cuda if accepted else merge_blocks_cuda
    plain = lambda store: merge_blocks_plain(cfg, store, blocks, vax, staged, resample,
                                             want_accepted=accepted)
    got, want = kernel(cfg, work, blocks, vax, staged, resample), plain(flat)
    torch.cuda.synchronize()
    acc_k, acc_p = got[1], want[1]
    if acc_k.dtype != acc_p.dtype or acc_k.shape != acc_p.shape or int(acc_k) != int(acc_p):
        raise AssertionError(f"[merge] {tag}: accepted {acc_k} against the plain {acc_p}")
    mask_bytes = 0
    if accepted:
        assert_equal(f"[merge] {tag} acceptance mask", got[2], want[2])
        mask_bytes = got[2].numel()
    err = 0.0
    for k in fields:
        a, b = getattr(work, k), getattr(flat, k)
        if a.dtype == torch.float32:
            err = max(err, max_err(a, b)[0])
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert_equal(f"[merge] {tag} {k}", a, b)
    changed = int((flat.status != keep["status"]).sum())

    def restore():
        for k in fields:
            getattr(work, k).copy_(keep[k])

    run = lambda: kernel(cfg, work, blocks, vax, staged, resample)
    ms, q_ms = cuda_ms(run, reps, setup=restore), cuda_ms(run, reps, queued=True, setup=restore)
    plain_ms = cuda_ms(lambda: plain(work), 3, setup=restore)
    b, n_real = merge_bound(cfg, blocks, staged, keep, flat, resample, acc_p)
    for k in fields:  # the inputs as they came: a second instance may run on them
        getattr(flat, k).copy_(keep[k])
    if accepted:
        b = bound(b["bound_ms"] * 1e-3 * HBM_BYTES_PER_S + mask_bytes)
    share = b["bound_ms"] / q_ms
    bv, K = staged.meta.shape[1:]
    what = "store bits, mask" if accepted else "store bits"
    print(f"[merge] {tag}{' (acceptance instance)' if accepted else ''}: A={blocks.ids.shape[0]} "
          f"rows ({n_real} real) of {bv} voxels x K={K}, resample {resample}: {what} and "
          f"accepted count ({int(acc_p)}) equal to the plain version, {changed} statuses "
          f"changed; kernel {ms:.4f} ms ({q_ms:.4f} device-only), plain {plain_ms:.3f} ms; bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']}, share {share:.3f} of the device-only time "
          f"({card})")
    del keep, work
    return {"ms": ms, "device_only_ms": q_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "accepted": int(acc_p), "rows": blocks.ids.shape[0], "real_rows": n_real,
            "resample": resample, "share": share, **b}


def check_merge(report, card):
    """Phase 2's merge kernel (csrc/birth.cu) against merge_blocks_plain at
    MERGE_SHAPES on the presets' full stores (``merge_inputs``); the
    VKITTI2 birth shape's numbers go to the report's top level."""
    import torch
    from semantic_dsp_map_tpu_torch import virtual_kitti2_config, zed2_config

    cfgs = {"vkitti2": virtual_kitti2_config(), "zed2": zed2_config()}
    entry = report["merge_blocks"]
    for label, preset, A, n_real, resample in MERGE_SHAPES:
        cfg = cfgs[preset]
        args = merge_inputs(cfg, A, n_real)
        out = check_merge_once(f"{label} shape", cfg, *args, resample, card)
        entry.setdefault("by_shape", {})[label] = out
        del args
        torch.cuda.empty_cache()
    top = entry["by_shape"]["vkitti2"]
    entry.update({k: top[k] for k in ("ms", "device_only_ms", "plain_ms", "max_abs_err",
                                      "bound_ms", "bound_by")})


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
    """[launch]: what a launch costs the host.  Each of the eight wrappers at
    its main shapes (the five frame kernels and birth's merge at VKITTI2
    shapes on the inputs of phase 2, the probes at theirs; the merge works
    in place, each launch on the store the last one left): its host time
    per launch in runs of
    200, beside the bare ctypes call of the same entry point on the same
    pointers and beside torch.mul on [8, 128] f32.  The wrapper's own cost
    is the difference from the bare call."""
    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, virtual_kitti2_config
    from semantic_dsp_map_tpu_torch.benchmarks import prim_bench7
    from semantic_dsp_map_tpu_torch.ops import observe_cuda, phd, phd_cuda, probes_cuda
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import merge_blocks_cuda
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
    _, _, birth_a, birth_real, _ = MERGE_SHAPES[0]
    merge_args = merge_inputs(cfg, birth_a, birth_real)
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
        ("merge_blocks", "dsp_merge_blocks", lambda: merge_blocks_cuda(cfg, *merge_args, True)),
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
    hold_runs(name, launches, frames, template=setup is not None)
    if need_moved and moved == 0:
        raise AssertionError(f"{name}: the rigid-move stage moved no particle")
    print(f"[tiny] {name}, {frames} frames: CUDA path equal to the CPU path "
          f"(moved {moved}, last diag {dgd}, launches {launches})")
    return cpu, gpu


def drive_k_pair(tag, counters, card, slots_n, frames):
    """A store of 2^slots_n - 1 slots a voxel at the reduced VKITTI2 grid
    (``scenes.REDUCED_VKITTI2``, 131,072 voxels), the reduced hostile scene
    through ``update()`` on two maps on the card in turns: one as the
    package builds it, one that runs the plain versions of the four
    per-voxel kernels (``use_pallas_render`` and ``use_pallas_observe`` off,
    ``merge_way("plain")``; the PHD kernels run in both): state, generator,
    render and counters bit-equal every frame, each kernel counted as often
    as the frames run it.  Returns (the numbers, the kernels' map)."""
    import collections

    from semantic_dsp_map_tpu_torch import (
        FilterParams, MaskKpts, SemanticDSPMap, virtual_kitti2_config,
    )

    scenes = bench_scenes()
    n = dict(max_particle_num_per_voxel_n=slots_n)
    cfg = virtual_kitti2_config(**scenes.REDUCED_VKITTI2, **n)
    plain_cfg = virtual_kitti2_config(**scenes.REDUCED_VKITTI2, **n, use_pallas_render=False,
                                      use_pallas_observe=False)
    params = FilterParams(**scenes.VK_PARAMS)
    ways = ("kernel", "plain")
    maps = {"kernel": SemanticDSPMap(cfg, params, device="cuda"),
            "plain": SemanticDSPMap(plain_cfg, params, device="cuda")}
    calls = collections.Counter()
    reset_launches(counters)
    born = moved = 0
    for t in range(frames):
        out = {}
        for way in ways if t % 2 == 0 else ways[::-1]:
            with merge_way(way, calls):
                out[way] = maps[way].update(*reduced_hostile_scene(cfg, t, MaskKpts))
        parted = frame_parting(*((maps[w].state, *out[w]) for w in ways))
        if parted:
            raise AssertionError(f"[{tag}] frame {t}: the plain versions' map parts from the "
                                 f"kernels' in {parted}")
        born += int(out["kernel"][1].born_count)
        moved += int(out["kernel"][1].moved_count)
    launches = read_launches(counters)
    # the PHD passes run in both maps, the four per-voxel kernels in one
    want = {f: frames * (2 if f.startswith("pass_") else runs_a_frame(f)) for f in launches}
    if launches != want or born == 0 or moved == 0:
        raise AssertionError(f"[{tag}] kernel runs {launches} (want {want}), born {born}, "
                             f"moved {moved}")
    print(f"[{tag}] K={cfg.slots_per_voxel} reduced hostile scene, {frames} frames, noise on, two "
          f"maps on the card in turns, the four per-voxel kernels against their plain versions: "
          f"state, generator, render and counters bit-equal every frame (born {born}, moved "
          f"{moved}); kernel runs {launches} ({card})")
    out = {"launches": launches, "born": born, "moved": moved, "frames": frames,
           "K": cfg.slots_per_voxel, "voxels": cfg.num_voxels}
    return out, maps["kernel"]


def check_k31(counters, card, frames=6):
    """[k31]: a store of 31 slots a voxel (``max_particle_num_per_voxel_n``
    5, the largest K of the kernels' main instances) at the reduced VKITTI2
    grid, the two maps of ``drive_k_pair`` in turns, bit-equal every frame.
    Then the four kernels on the map's store against their plain versions
    (the render, the front and movable scans byte for byte, birth's merge on
    a working set of that grid bit for bit), each timed.  Larger K run in
    [wide].  Returns the numbers."""
    import torch

    out, gpu = drive_k_pair("k31", counters, card, 5, frames)
    store_kernels("k31", out, gpu, card)
    del gpu
    torch.cuda.empty_cache()
    return out


def store_kernels(tag, out, gpu, card):
    """The four per-voxel kernels on the store of the map ``gpu`` against
    their plain versions: the render, the front and movable scans byte for
    byte, birth's merge on a working set of that grid (``merge_inputs``) bit
    for bit; each timed (ms and device-only ms) into ``out``."""
    import torch
    from semantic_dsp_map_tpu_torch.ops import codecs
    from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices
    from semantic_dsp_map_tpu_torch.ops.observe import front_candidates_plain, movable_voxels_plain
    from semantic_dsp_map_tpu_torch.ops.observe_cuda import (
        front_candidates_cuda, movable_voxels_cuda,
    )

    cfg = gpu.cfg
    st = gpu.state
    p, vst = st.particles, st.voxel_stamp
    vax = codecs.axis_stamps_per_voxel(cfg, st.scroll)
    n_set = int((p.status != 0).sum())
    if n_set == 0:
        raise AssertionError(f"[{tag}] the map's store holds no particle")
    thr = 0.4
    pk, r_k, errs, bits = check_render_once(f"[{tag}] the map's store", cfg, p, vst, vax, thr)
    c = render_census(cfg, p, pk, vax, vst, r_k)
    del pk, r_k
    run, restore = render_runner(cfg, p, vst, vax, thr)
    out["render"] = {"ms": cuda_ms(run, 10, setup=restore),
                     "device_only_ms": cuda_ms(run, 10, queued=True, setup=restore),
                     "max_abs_err": max(errs), "sums_bit_equal": bits,
                     **{k: c[k] for k in ("with_status", "alive", "listed_voxels",
                                          "alive_per_listed_mean", "alive_per_listed_max")},
                     **c["bound"]}
    print(f"[{tag}] render census: {census_line(c)}")
    quat = torch.tensor([0.9833, 0.0428, 0.1737, 0.0076], device="cuda")
    _, _, r_cw, t_cw = camera_matrices(torch.tensor([0.3, -0.2, 0.5], device="cuda"),
                                       quat / quat.norm())
    fargs = (cfg, p.px, p.py, p.pz, p.status, p.stamp, vax, r_cw, t_cw)
    for name, got, want in zip(("has_alive", "has_cand"), front_candidates_cuda(*fargs),
                               front_candidates_plain(*fargs)):
        assert_equal(f"[{tag}] front {name}", got, want)
    margs = (cfg, p.track, p.status, p.stamp, vax, gpu.registry.max_movable_instance_id)
    hm = movable_voxels_cuda(*margs)
    assert_equal(f"[{tag}] movable", hm, movable_voxels_plain(*margs))
    for key, fn in (("front_candidates", lambda: front_candidates_cuda(*fargs)),
                    ("movable_voxels", lambda: movable_voxels_cuda(*margs))):
        out[key] = {"ms": cuda_ms(fn, 10), "device_only_ms": cuda_ms(fn, 10, queued=True)}
    out["front_candidates"].update(front_bound(fargs, *front_candidates_cuda(*fargs))[0])
    out["movable_voxels"].update(movable_bound(cfg, p.status, p.stamp, vax)[0])
    working_set = merge_inputs(cfg, cfg.max_birth_blocks, 400)
    out["merge_blocks"] = check_merge_once(f"{tag} shape", cfg, *working_set, True, card)
    out["merge_blocks_accepted"] = check_merge_once(f"{tag} shape", cfg, *working_set, True, card,
                                                    accepted=True)
    del working_set
    share = lambda key: out[key]["bound_ms"] / out[key]["device_only_ms"]
    print(f"[{tag}] K={cfg.slots_per_voxel} at {cfg.num_voxels} voxels, the map's store ({n_set} "
          f"slots with a status): render, front and movable scans equal to their plain versions "
          f"(render sums bit-equal: {bits}); device-only ms (bound, share): render "
          f"{out['render']['device_only_ms']:.4f} ({out['render']['bound_ms']:.4f}, "
          f"{share('render'):.3f}), front {out['front_candidates']['device_only_ms']:.4f} "
          f"({out['front_candidates']['bound_ms']:.4f}, {share('front_candidates'):.3f}), movable "
          f"{out['movable_voxels']['device_only_ms']:.4f} ({out['movable_voxels']['bound_ms']:.4f}, "
          f"{share('movable_voxels'):.3f}), merge {out['merge_blocks']['device_only_ms']:.4f} "
          f"({out['merge_blocks']['bound_ms']:.4f}, {out['merge_blocks']['share']:.3f}), its "
          f"acceptance instance {out['merge_blocks_accepted']['device_only_ms']:.4f} "
          f"({out['merge_blocks_accepted']['bound_ms']:.4f}, "
          f"{out['merge_blocks_accepted']['share']:.3f}) ({card})")
    del p


# ---------------------------------------------------------------------------
# [wide]: the stores and stencils past the main instances
# ---------------------------------------------------------------------------


def compact_rows(cfg, flat, blocks, vax):
    """Birth's merge working set with the store cut to its target rows: the
    real rows' slots of ``flat`` copied into a store of their own, in order,
    their voxels' scroll stamps, the ids renumbered (real rows 0 .. n - 1,
    padding rows n + row).  The kernel and the plain version compute each
    row from its own slots alone, so this is the same work on a store that
    can be copied where the whole one (14.3 GB at K = 63) could not.
    Returns (flat, blocks, vox_axis)."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch.ops.blocks import block_layout

    bv, nb, spb = block_layout(cfg)
    ids = blocks.ids
    real = ids < nb
    n = int(real.sum())
    rows = ids[:n]
    slots = (rows[:, None] * spb + torch.arange(spb, device=ids.device)).reshape(-1)
    voxels = (rows[:, None] * bv + torch.arange(bv, device=ids.device)).reshape(-1)
    sub = type(flat)(**{f.name: getattr(flat, f.name)[slots].contiguous()
                        for f in dataclasses.fields(flat)})
    new_ids = torch.arange(ids.shape[0], device=ids.device)
    new_ids[n:] += n
    return sub, blocks._replace(ids=new_ids), vax[voxels].contiguous()


class MergeRecorder:
    """Stands in for ``ops.birth.merge_blocks`` for one frame: keeps each
    call's working set with the store cut to its target rows
    (``compact_rows``, copied before the merge changes them) and passes the
    call on."""

    def __init__(self):
        from semantic_dsp_map_tpu_torch.ops import birth

        self.module, self.fn, self.calls = birth, birth.merge_blocks, []

    def __call__(self, cfg, flat, blocks, vax, staged, resample, *args, **kwargs):
        sub, sub_blocks, sub_vax = compact_rows(cfg, flat, blocks, vax)
        self.calls.append((cfg, sub, sub_blocks, sub_vax,
                           type(staged)(*(x.clone() for x in staged)), resample))
        return self.fn(cfg, flat, blocks, vax, staged, resample, *args, **kwargs)

    def __enter__(self):
        self.module.merge_blocks = self
        return self

    def __exit__(self, *exc):
        self.module.merge_blocks = self.fn


def wide_k63(counters, card, frames=6):
    """[wide] (a): the full VKITTI2 grid at K = 63
    (``virtual_kitti2_config(max_particle_num_per_voxel_n=6)``: 8,388,608
    voxels, 528,482,304 slots, a 14.3 GB store) at 1242 x 375:
    ``frames`` frames of the vkitti2 scene with its noise on through
    ``update()`` (captured from the second frame on), each kernel's
    launches counted (``drive_main_path``).  Then one more frame through
    the eager step, its PHD passes' arguments and its two merges' working
    sets recorded, and on the map's store after it each kernel against its
    plain version on the card, timed with its bound: the render, the front
    and movable scans (byte for byte), both merge instances on the frame's
    birth working set and the count-only one on its moving-object cleanup's
    (bit for bit; ``compact_rows``), both PHD passes; and the peak memory.
    One map only: a second 14.3 GB store with the plain versions'
    temporaries beside it would not leave room on an 80 GB card for frames
    in turns, so the kernels are held to their plain versions on the one
    store.  Returns the numbers."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, virtual_kitti2_config
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.map import build_frame_step, unpack_frame
    from semantic_dsp_map_tpu_torch.ops import codecs, phd_cuda
    from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices
    from semantic_dsp_map_tpu_torch.ops.observe import front_candidates_plain, movable_voxels_plain
    from semantic_dsp_map_tpu_torch.ops.observe_cuda import (
        front_candidates_cuda, movable_voxels_cuda,
    )
    from semantic_dsp_map_tpu_torch.ops.render import render_core_plain

    scenes = bench_scenes()
    synth = scenes.synth_vkitti2_frame
    cfg = virtual_kitti2_config(max_particle_num_per_voxel_n=6)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches, median_ms, dsp, frame_ms, _ = drive_main_path(
        "wide_k63", cfg, FilterParams(**scenes.VK_PARAMS), synth, counters, card, warmup=3,
        frames=frames - 3)
    peak_frames = torch.cuda.max_memory_allocated()
    p = dsp.state.particles
    store = sum(nbytes(getattr(p, f.name)) for f in dataclasses.fields(p))
    print(f"[wide] wide_k63: {frames} frames through update() (median {median_ms:.3f} ms), the "
          f"store {store / 1e9:.2f} GB, peak memory {peak_frames / 1e9:.2f} GB; launches "
          f"{launches} ({card})")
    out = {"frames": frames, "frame_ms": frame_ms, "median_ms": median_ms, "launches": launches,
           "store_bytes": store, "peak_bytes_frames": peak_frames,
           "slots": cfg.num_voxels * cfg.slots_per_voxel}

    # one more frame, eager, its passes' arguments and merges' working sets kept
    t = frames
    depth, masks, pos, quat = synth(cfg, t, MaskKpts)
    step = build_frame_step(cfg, dsp.params, dsp.registry)
    buf = pack_frame(cfg, dsp.registry, depth, masks, pos, quat, 0.1 * t - dsp._time_origin)
    f = unpack_frame(cfg, dsp._static_table, torch.from_numpy(buf).cuda())
    with (CallRecorder(phd_cuda, "pass_a_cuda") as rec_a,
          CallRecorder(phd_cuda, "pass_b_cuda") as rec_b, MergeRecorder() as rec_m):
        dsp.state, _, _ = step(dsp.state, f)
    torch.cuda.synchronize()
    del step, f
    if (len(rec_a.calls), len(rec_b.calls), len(rec_m.calls)) != (1, 1, 2):
        raise AssertionError(f"[wide] wide_k63 frame {t}: {len(rec_a.calls)} pass A, "
                             f"{len(rec_b.calls)} pass B, {len(rec_m.calls)} merge calls")
    st = dsp.state
    p, vst = st.particles, st.voxel_stamp
    vax = codecs.axis_stamps_per_voxel(cfg, st.scroll)
    thr = dsp.params.occupancy_threshold

    pk, r_k, (e1, e2), bits = check_render_once("wide_k63 store", cfg, p, vst, vax, thr)
    c = render_census(cfg, p, pk, vax, vst, r_k)
    del pk, r_k
    run, restore = render_runner(cfg, p, vst, vax, thr)
    out["render"] = {"ms": cuda_ms(run, 5, setup=restore),
                     "device_only_ms": cuda_ms(run, 5, queued=True, setup=restore),
                     "plain_ms": cuda_ms(lambda: render_core_plain(cfg, p, vst, vax, thr), 1),
                     "max_abs_err": max(e1, e2), "sums_bit_equal": bits,
                     **{k: c[k] for k in ("with_status", "alive", "listed_voxels",
                                          "alive_per_listed_mean", "alive_per_listed_max")},
                     **c["bound"]}
    print(f"[wide] wide_k63 render census: {census_line(c)}")
    del run, restore
    torch.cuda.empty_cache()

    _, _, r_cw, t_cw = camera_matrices(torch.as_tensor(np.asarray(pos), device="cuda"),
                                       torch.as_tensor(np.asarray(quat), device="cuda"))
    fargs = (cfg, p.px, p.py, p.pz, p.status, p.stamp, vax, r_cw, t_cw)
    ha, hc = front_candidates_cuda(*fargs)
    ha_p, hc_p = front_candidates_plain(*fargs)
    assert_equal("[wide] wide_k63 front has_alive", ha, ha_p)
    assert_equal("[wide] wide_k63 front has_cand", hc, hc_p)
    del ha_p, hc_p
    fb, n_alive, _ = front_bound(fargs, ha, hc)
    run = lambda: front_candidates_cuda(*fargs)
    out["front_candidates"] = {
        "ms": cuda_ms(run, 5), "device_only_ms": cuda_ms(run, 5, queued=True),
        "plain_ms": cuda_ms(lambda: front_candidates_plain(*fargs), 1), "max_abs_err": 0.0,
        "alive_slots": n_alive, "candidate_voxels": int(hc.sum()), **fb}
    margs = (cfg, p.track, p.status, p.stamp, vax, dsp.registry.max_movable_instance_id)
    hm = movable_voxels_cuda(*margs)
    assert_equal("[wide] wide_k63 movable", hm, movable_voxels_plain(*margs))
    run = lambda: movable_voxels_cuda(*margs)
    out["movable_voxels"] = {
        "ms": cuda_ms(run, 5), "device_only_ms": cuda_ms(run, 5, queued=True),
        "plain_ms": cuda_ms(lambda: movable_voxels_plain(*margs), 1), "max_abs_err": 0.0,
        "movable_voxels": int(hm.sum()), **movable_bound(cfg, p.status, p.stamp, vax)[0]}
    for key, what in (("render", f"occ, label, track, status equal, sums bit-equal: {bits}"),
                      ("front_candidates", f"bytes equal, {n_alive} live slots, "
                                           f"{int(hc.sum())} candidate voxels"),
                      ("movable_voxels", f"bytes equal, {int(hm.sum())} movable voxels")):
        o = out[key]
        print(f"[wide] wide_k63 {key} on the map's store: {what}; kernel {o['ms']:.4f} ms "
              f"({o['device_only_ms']:.4f} device-only), plain {o['plain_ms']:.3f} ms, bound "
              f"{o['bound_ms']:.4f} ms by {o['bound_by']}, share "
              f"{o['bound_ms'] / o['device_only_ms']:.3f} ({card})")
    del fargs, margs, ha, hc, hm, run
    torch.cuda.empty_cache()

    move, birth_set = rec_m.calls
    out["merge"] = {"move_cleanup": check_merge_once("wide_k63 move cleanup", *move, card),
                    "birth": check_merge_once("wide_k63 birth", *birth_set, card)}
    out["merge_accepted"] = check_merge_once("wide_k63 birth", *birth_set, card, accepted=True)
    out["merge_accepted_cleanup"] = check_merge_once("wide_k63 move cleanup", *move, card,
                                                     accepted=True)
    out["phd"] = wide_pass(f"wide_k63 frame {t}", rec_a.calls[0], rec_b.calls[0], card)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"[wide] wide_k63: peak memory {out['peak_bytes'] / 1e9:.2f} GB with the plain "
          f"versions' checks ({card})")
    del dsp, st, p, vst, vax, rec_a, rec_b, rec_m, move, birth_set
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: [wide] (c): the half-widths and the table depth past the presets'.
WIDE_R = (9, 12, 16)
WIDE_S = 512


def recorded_passes(cfg, params, t0=3):
    """A VKITTI2 map at ``cfg`` driven ``t0`` frames through ``update()``,
    then one eager frame whose PHD pass arguments are recorded: (pass A's,
    pass B's) arguments of that real frame."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts, SemanticDSPMap
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.map import build_frame_step, unpack_frame
    from semantic_dsp_map_tpu_torch.ops import phd_cuda

    synth = bench_scenes().synth_vkitti2_frame
    dsp = SemanticDSPMap(cfg, params, device="cuda")
    for t in range(t0):
        dsp.update(*synth(cfg, t, MaskKpts), 0.1 * t)
    step = build_frame_step(cfg, params, dsp.registry)
    buf = pack_frame(cfg, dsp.registry, *synth(cfg, t0, MaskKpts), 0.1 * t0)
    f = unpack_frame(cfg, dsp._static_table, torch.from_numpy(buf).cuda())
    with (CallRecorder(phd_cuda, "pass_a_cuda") as rec_a,
          CallRecorder(phd_cuda, "pass_b_cuda") as rec_b):
        dsp.state, _, _ = step(dsp.state, f)
    torch.cuda.synchronize()
    if (len(rec_a.calls), len(rec_b.calls)) != (1, 1):
        raise AssertionError(f"[wide] {len(rec_a.calls)} pass A and {len(rec_b.calls)} pass B "
                             "calls")
    return rec_a.calls[0], rec_b.calls[0]


def wide_pass(tag, a_args, b_args, card):
    """Passes A and B on recorded arguments against the plain stencils
    (``check_pass_a``, ``check_pass_b``: floats within rtol 2e-5 / atol
    1e-6, pass A's two launches bit-equal, the flags equal away from the
    threshold), each timed with its bound.  Returns the numbers."""
    from semantic_dsp_map_tpu_torch.ops import phd, phd_cuda

    out = {}
    ck, (a_abs, _) = check_pass_a(tag, a_args)
    census = pass_a_census(a_args)
    b, _, _ = pass_a_bound(a_args, ck, census)
    run = lambda: phd_cuda.pass_a_cuda(*a_args)
    out["pass_a"] = {"ms": cuda_ms(run, 5), "device_only_ms": cuda_ms(run, 5, queued=True),
                     "plain_ms": cuda_ms(lambda: phd.pass_a_raw(*a_args), 1), "max_abs_err": a_abs,
                     "terms": census["terms"], "live_entries": census["live_entries"], **b}
    acc, right, (b_abs, _), n_near = check_pass_b(tag, b_args)
    b, _, terms = pass_b_bound(b_args, acc, right)
    run = lambda: phd_cuda.pass_b_cuda(*b_args)
    out["pass_b"] = {"ms": cuda_ms(run, 5), "device_only_ms": cuda_ms(run, 5, queued=True),
                     "plain_ms": cuda_ms(lambda: phd.pass_b_raw(*b_args), 1), "max_abs_err": b_abs,
                     "terms": terms, "near_threshold": n_near, **b}
    S, H, W = a_args[2].shape
    for key in ("pass_a", "pass_b"):
        o = out[key]
        print(f"[wide] {tag} {key} (S={S}, R={a_args[0].neighbor_half}, {H}x{W}): within rtol "
              f"{RTOL} of the plain stencil (max abs {o['max_abs_err']:.3e}), {o['terms']} terms; "
              f"kernel {o['ms']:.4f} ms ({o['device_only_ms']:.4f} device-only), plain "
              f"{o['plain_ms']:.3f} ms; bound {o['bound_ms']:.4f} ms by {o['bound_by']}, share "
              f"{o['bound_ms'] / o['device_only_ms']:.3f} ({card})")
    return out


def sliced(args, S, R=None):
    """A pass's arguments with the table cut to its first ``S`` planes (a
    real table never fills a pixel past slot 12, so what is cut is empty)
    and, given ``R``, that half-width."""
    import dataclasses

    import torch

    cfg = dataclasses.replace(args[0], phd_pixel_table_slots=S,
                              **({} if R is None else {"phd_neighbor_half": R}))
    return (cfg, args[1], *(a[:S].contiguous() if isinstance(a, torch.Tensor) and a.dim() == 3
                            else a for a in args[2:]))


def switch_pair(tag, key, main_args, wide_args, card):
    """[wide]: one pass at a shape its main instance runs and at the first
    shape its wide one runs, each against the plain stencil (``check_pass_a``
    / ``check_pass_b``) and timed beside its bound, and the device-only time
    per term of each (a cliff at the switch shows as a jump in it).  Pass B's
    two shapes share their planes, whose sums and flags must be bit-equal.
    Returns the numbers."""
    import torch
    from semantic_dsp_map_tpu_torch.ops import phd_cuda

    out, held = {}, {}
    for label, args in (("main", main_args), ("wide", wide_args)):
        if key == "pass_a":
            ck, (err, _) = check_pass_a(f"{tag} {label}", args)
            census = pass_a_census(args)
            b, _, _ = pass_a_bound(args, ck, census)
            terms = census["terms"]
            run = lambda: phd_cuda.pass_a_cuda(*args)
        else:
            acc, right, (err, _), _ = check_pass_b(f"{tag} {label}", args)
            held[label] = (acc, right)
            b, _, terms = pass_b_bound(args, acc, right)
            run = lambda: phd_cuda.pass_b_cuda(*args)
        dev = cuda_ms(run, 10, queued=True)
        out[label] = {"S": args[2].shape[0], "R": args[0].neighbor_half, "ms": cuda_ms(run, 10),
                      "device_only_ms": dev, "terms": terms, "ns_per_term": dev * 1e6 / terms,
                      "max_abs_err": err, **b}
    if key == "pass_b":
        (acc_m, right_m), (acc_w, right_w) = held["main"], held["wide"]
        S = acc_m.shape[0]
        assert_equal(f"[wide] {tag}: pass B's sums on the shared planes",
                     acc_w[:S].view(torch.int32), acc_m.view(torch.int32))
        assert_equal(f"[wide] {tag}: pass B's flags on the shared planes", right_w[:S], right_m)
    out["per_term_ratio"] = out["wide"]["ns_per_term"] / out["main"]["ns_per_term"]
    m, w = out["main"], out["wide"]
    print(f"[wide] {tag} {key}: main instance at S={m['S']} R={m['R']} {m['device_only_ms']:.4f} ms "
          f"device-only ({m['ms']:.4f}), {m['terms']} terms, {m['ns_per_term']:.6f} ns a term, bound "
          f"{m['bound_ms']:.4f} ms by {m['bound_by']} (share {m['bound_ms'] / m['device_only_ms']:.3f}); "
          f"wide at S={w['S']} R={w['R']} {w['device_only_ms']:.4f} ms ({w['ms']:.4f}), {w['terms']} "
          f"terms, {w['ns_per_term']:.6f} ns a term, bound {w['bound_ms']:.4f} ms by {w['bound_by']} "
          f"(share {w['bound_ms'] / w['device_only_ms']:.3f}); wide / main a term "
          f"{out['per_term_ratio']:.3f}" + ("; sums and flags bit-equal on the shared planes"
                                              if key == "pass_b" else "") + f" ({card})")
    return out


def live_plane_kernels(a_args, b_args, card):
    """[wide]: the two live-plane passes (``live_weights_cuda``,
    ``live_tracks_cuda``) on a real frame's pass arguments against
    ``ops.phd.live_planes`` (words equal; pass B's acc and right zeroed at
    the empty entries, the rest untouched), timed beside their bound: the
    table's deciding plane read once, the words written once, and for pass B
    acc and right written at every empty entry.  Returns the numbers."""
    import torch
    from semantic_dsp_map_tpu_torch.ops import phd, phd_cuda

    weff, trk = a_args[5], b_args[5]
    S, H, W = weff.shape
    words = -(-S // 32) * H * W * 4
    out = {}
    live = phd_cuda.live_weights_cuda(weff)
    assert_equal("[wide] live_weights words", live, phd.live_planes(weff != 0))
    occupied = trk != -2
    acc = torch.full(trk.shape, 7.0, device=trk.device)
    right = torch.ones(trk.shape, dtype=torch.bool, device=trk.device)
    live = phd_cuda.live_tracks_cuda(trk, acc, right)
    assert_equal("[wide] live_tracks words", live, phd.live_planes(occupied))
    assert_equal("[wide] live_tracks acc", acc, torch.where(occupied, 7.0, 0.0))
    assert_equal("[wide] live_tracks right", right, occupied)
    empty = int((~occupied).sum())
    for key, run, plain, n in (
            ("phd_live_weights", lambda: phd_cuda.live_weights_cuda(weff),
             lambda: phd.live_planes(weff != 0), nbytes(weff) + words),
            ("phd_live_tracks", lambda: phd_cuda.live_tracks_cuda(trk, acc, right),
             lambda: phd.live_planes(trk != -2), nbytes(trk) + words + 5 * empty)):
        dev = cuda_ms(run, 10, queued=True)
        out[key] = {"ms": cuda_ms(run, 10), "device_only_ms": dev, "plain_ms": cuda_ms(plain, 3),
                    "max_abs_err": 0.0, "bytes": n, **bound(n)}
        o = out[key]
        print(f"[wide] {key} (S={S}, {H}x{W}, real frame): words equal to the plain version; "
              f"kernel {o['ms']:.4f} ms ({dev:.4f} device-only), plain {o['plain_ms']:.3f} ms; "
              f"{n} bytes, bound {o['bound_ms']:.4f} ms by {o['bound_by']}, share "
              f"{o['bound_ms'] / dev:.3f} ({card})")
    return out


def full_table_pass_a(card, S=512, R=5, H=94, W=311):
    """[wide]: pass A wide on a table with every entry of its S = 512 planes
    live (61,952 terms a pixel at R = 5, the shape where one accumulator
    parted by 5.1e-5) against the plain stencil, two launches bit-equal.
    Returns (max abs, max rel) error."""
    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, tiny_test_config

    cfg = tiny_test_config(image_width=W, image_height=H, phd_pixel_table_slots=S,
                           phd_neighbor_half=R)
    params = FilterParams(detection_probability=0.9, noise_number=0.1, if_consider_depth_noise=True)
    t, cloud, fill = phd_inputs(cfg, seed=2, fill=4.0)
    weff = torch.where(t.meta >= 0, t.weight, 0.0)
    if fill != 1.0 or not bool((weff != 0).all()):
        raise AssertionError(f"[wide] full table: occupied share {fill}")
    _, err = check_pass_a(f"full table S={S}", pass_a_inputs(cfg, params, t, cloud, weff))
    print(f"[wide] pass A wide on a full table (S={S}, R={R}, {H}x{W}, "
          f"{S * (2 * R + 1) ** 2} terms a pixel): within rtol {RTOL} of the plain stencil, max abs "
          f"{err[0]:.3e}, max rel {err[1]:.3e}; two launches bit-equal ({card})")
    return err


def drive_wide_map(cfg, params, counters, card, frames=4):
    """[wide]: a VKITTI2 map at ``cfg`` through ``update()`` (frame 0 eager,
    frame 1 captured, replays after) and, on the same frames of the vkitti2
    scene with its noise on, the eager step (``build_frame_stages``' parts)
    on a state of its own: state (the generator too), render and counters
    bit-equal every frame.  Each kernel of ``counters`` must run once a frame
    in the map.  Returns the map's launches and its last frame's counters."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts, SemanticDSPMap, step_graph
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.map import build_frame_stages, unpack_frame
    from semantic_dsp_map_tpu_torch.objects import refit_svd
    from semantic_dsp_map_tpu_torch.state import init_map_state

    synth = bench_scenes().synth_vkitti2_frame
    dsp = SemanticDSPMap(cfg, params, device="cuda")
    stages = build_frame_stages(cfg, params, dsp.registry)
    state = init_map_state(cfg, 0, "cuda")
    split = step_graph.split_at_refit(cfg)
    reset_launches(counters)
    runs = {fn.__name__: 0 for fn in counters}
    for t in range(frames):
        scene = synth(cfg, t, MaskKpts)
        before = read_launches(counters)
        result, diag = dsp.update(*scene, 0.1 * t)
        torch.cuda.synchronize()
        after = read_launches(counters)
        ran = {k: after[k] - before[k] for k in after}
        if set(ran.values()) != {1}:
            raise AssertionError(f"[wide] S={cfg.phd_pixel_table_slots} map frame {t}: kernel runs "
                                 f"{ran}")
        runs = {k: runs[k] + ran[k] for k in runs}
        f = unpack_frame(cfg, dsp._static_table,
                         torch.from_numpy(pack_frame(cfg, dsp.registry, *scene, 0.1 * t)).cuda())
        if split:
            fit = stages.objects_fit(state, f)
            objects = stages.objects_finish(fit, *refit_svd(fit))
        else:
            objects = stages.objects(state, f)
        state, result_e, diag_e = stages.rest(state, f, objects)
        torch.cuda.synchronize()
        parted = states_differ(dsp.state, state)
        parted += [n for n in result._fields if not torch.equal(getattr(result, n),
                                                                getattr(result_e, n))]
        counts = {k: int(v) for k, v in diag._asdict().items()}
        if counts != {k: int(v) for k, v in diag_e._asdict().items()}:
            parted.append("diagnostics")
        if parted:
            raise AssertionError(f"[wide] S={cfg.phd_pixel_table_slots} map frame {t}: the map "
                                 f"parts from the eager step in {parted}")
    graphs = sorted(dsp._static.graphs)
    if not graphs or counts["visible_count"] == 0:
        raise AssertionError(f"[wide] S={cfg.phd_pixel_table_slots} map: graphs {graphs}, "
                             f"counters {counts}")
    print(f"[wide] S={cfg.phd_pixel_table_slots}: {frames} VKITTI2 frames through update() "
          f"(graphs {graphs}), each frame's state, render and counters bit-equal to the eager "
          f"step's; the map's kernel runs {runs}; last frame {counts} ({card})")
    del dsp, state
    torch.cuda.empty_cache()
    return {"frames": frames, "launches": runs, "diag": counts,
            "graphs": [list(g) for g in graphs]}


def wide_stencils(counters, card, r12_frames=4):
    """[wide] (c): a real VKITTI2 frame's pixel table (the default preset,
    S = 12) through passes A and B at R = 9, 12 and 16 against the plain
    stencils (``wide_pass``); a VKITTI2 map at S = 512 (the table of a real
    frame, R = 5) likewise, its live-plane passes (``live_plane_kernels``),
    and pass A wide on a full S = 512 table (``full_table_pass_a``); each
    pass's first wide shape beside the main one just below it
    (``switch_pair``: pass A at S = 67 / 68 and R = 12 / 13, pass B at
    S = 431 / 432, all real frames); the S = 512 map captured against eager,
    4 frames (``drive_wide_map``); then ``r12_frames`` VKITTI2 frames at
    ``phd_neighbor_half=12`` through ``update()``, both passes counted once
    a frame.  Returns the numbers."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch import (
        FilterParams, MaskKpts, SemanticDSPMap, virtual_kitti2_config,
    )
    from semantic_dsp_map_tpu_torch.ops import phd_cuda

    scenes = bench_scenes()
    params = FilterParams(**scenes.VK_PARAMS)
    out = {}
    a_args, b_args = recorded_passes(virtual_kitti2_config(), params)
    for R in WIDE_R:
        cfg = dataclasses.replace(a_args[0], phd_neighbor_half=R)
        out[f"R{R}"] = wide_pass(f"real frame R={R}", (cfg, *a_args[1:]), (cfg, *b_args[1:]), card)
    out["switch_a_r13"] = switch_pair("real frame S=12, R=12 / 13", "pass_a",
                                      sliced(a_args, 12, 12), sliced(a_args, 12, 13), card)
    del a_args, b_args
    torch.cuda.empty_cache()
    a_args, b_args = recorded_passes(virtual_kitti2_config(phd_pixel_table_slots=WIDE_S), params)
    out[f"S{WIDE_S}"] = wide_pass(f"real frame S={WIDE_S}", a_args, b_args, card)
    out["live_planes"] = live_plane_kernels(a_args, b_args, card)
    out["switch_a_s68"] = switch_pair("real frame R=5, S=67 / 68", "pass_a", sliced(a_args, 67),
                                      sliced(a_args, 68), card)
    out["switch_b_s432"] = switch_pair("real frame R=5, S=431 / 432", "pass_b",
                                       sliced(b_args, 431), sliced(b_args, 432), card)
    del a_args, b_args
    torch.cuda.empty_cache()
    out["full_table_a"] = full_table_pass_a(card)
    torch.cuda.empty_cache()
    wide_fns = [fn for fn in counters if fn.__name__.startswith("pass_")]
    wide_fns += [phd_cuda.live_weights_cuda, phd_cuda.live_tracks_cuda]
    out["s512_map"] = drive_wide_map(virtual_kitti2_config(phd_pixel_table_slots=WIDE_S), params,
                                     wide_fns, card)

    cfg = virtual_kitti2_config(phd_neighbor_half=12)
    dsp = SemanticDSPMap(cfg, params, device="cuda")
    passes = [fn for fn in counters if fn.__name__.startswith("pass_")]
    reset_launches(passes)
    for t in range(r12_frames):
        _, diag = dsp.update(*scenes.synth_vkitti2_frame(cfg, t, MaskKpts), 0.1 * t)
    launches = read_launches(passes)
    if launches != {fn.__name__: r12_frames for fn in passes} or int(diag.visible_count) == 0:
        raise AssertionError(f"[wide] R=12 map: launches {launches}, diag {diag}")
    out["r12_map"] = {"frames": r12_frames, "launches": launches,
                      "diag": {k: int(v) for k, v in diag._asdict().items()}}
    print(f"[wide] R=12: {r12_frames} VKITTI2 frames through update(), launches {launches}, last "
          f"frame {out['r12_map']['diag']} ({card})")
    del dsp
    torch.cuda.empty_cache()
    return out


def check_k63_sharded(card, frames=3):
    """[wide] (b): the sharded step at K = 63 on the reduced VKITTI2 grid in
    the one-rank process group (NCCL): the captured step
    (``build_shard_step``: frame 0 eager, frame 1 captured, replays after)
    against the eager one (``build_shard_step_eager``), the reduced hostile
    scene, bit-equal every frame (state, both generators, render,
    counters).  Run inside [sharded]'s group (``one_rank_group``), whose
    captures come after it: a group made and destroyed before other
    captures leaves threads that can invalidate them.  Returns the
    numbers."""
    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, virtual_kitti2_config
    from semantic_dsp_map_tpu_torch.frontend import FrameInput, build_frame_input
    from semantic_dsp_map_tpu_torch.labels import LabelRegistry
    from semantic_dsp_map_tpu_torch.parallel.shard_step import (
        build_shard_step, build_shard_step_eager,
    )
    from semantic_dsp_map_tpu_torch.parallel.sharding import shard_state
    from semantic_dsp_map_tpu_torch.state import init_map_state

    scenes = bench_scenes()
    cfg = virtual_kitti2_config(**scenes.REDUCED_VKITTI2, max_particle_num_per_voxel_n=6)
    params, registry = FilterParams(**scenes.VK_PARAMS), LabelRegistry.default()
    ways = ("eager", "captured")
    steps = {"eager": build_shard_step_eager(cfg, params, registry),
             "captured": build_shard_step(cfg, params, registry)}
    states = {w: shard_state(cfg, init_map_state(cfg, 0, "cuda"), 0, 1) for w in ways}
    born = 0
    for t in range(frames):
        f = FrameInput(*(torch.as_tensor(np.asarray(a)).to("cuda") for a in build_frame_input(
            cfg, registry, *reduced_hostile_scene(cfg, t, MaskKpts))))
        out = {}
        for way in ways if t % 2 == 0 else ways[::-1]:
            out[way] = steps[way](states[way], f)
            states[way] = out[way][0]
        torch.cuda.synchronize()
        parted = sharded_parting(out["captured"], out["eager"],
                                 steps["captured"].stages.rank_rng.gen,
                                 steps["eager"].stages.rank_rng.gen)
        if parted:
            raise AssertionError(f"[wide] sharded K=63 frame {t}: the captured step parts from the "
                                 f"eager one in {parted}")
        born += int(out["eager"][2].born_count)
    graphs = sorted(steps["captured"].static.graphs)
    if not graphs or born == 0:
        raise AssertionError(f"[wide] sharded K=63: graphs {graphs}, born {born}")
    print(f"[wide] sharded step K={cfg.slots_per_voxel} at one rank ({cfg.num_voxels} voxels): "
          f"{frames} frames of the captured step (graphs {graphs}) bit-equal to the eager one "
          f"(state, both generators, render, counters), born {born} ({card})")
    del steps, states, out
    torch.cuda.empty_cache()
    return {"frames": frames, "K": cfg.slots_per_voxel, "graphs": [list(g) for g in graphs],
            "born": born}


def run_wide(counters, card) -> dict:
    """[wide]: (a) ``wide_k63``; (b) the reduced grid at K = 63 and 127,
    two maps in turns (``drive_k_pair``) and the four kernels on the
    kernels' map's store (``store_kernels``); (c) ``wide_stencils``.  The
    sharded step at K = 63 (``check_k63_sharded``) runs in [sharded]'s
    process group.  Returns the numbers."""
    import torch

    t0 = time.perf_counter()
    out = {"k63_full": wide_k63(counters, card)}
    for slots_n in (6, 7):
        tag = f"wide_k{(1 << slots_n) - 1}"
        pair, gpu = drive_k_pair(tag, counters, card, slots_n, 4)
        store_kernels(tag, pair, gpu, card)
        out[tag + "_reduced"] = pair
        del gpu
        torch.cuda.empty_cache()
    out["stencils"] = wide_stencils(counters, card)
    out["seconds"] = time.perf_counter() - t0
    print(f"[wide] (a)-(c) in {out['seconds']:.1f} s ({card})")
    return out


def check_template_scene(counters):
    """The small template scene CUDA vs CPU for 3 frames with the birth
    jitter off (the two devices draw different normals): the birth sweeps
    on frame 0 on both devices, the sweep records (count, gate row, score
    of each stage) are equal, and the GUESSED_BORN particles agree."""
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
    sc, sg = cpu._templates.records, gpu._templates.records
    counts = {stage: int(r.count) for stage, r in sg.items()}
    if counts != {"rematch": 0, "birth": 1}:
        raise AssertionError(f"template scene: sweeps on the card {counts}")
    for stage in sc:
        for field in ("count", "gate_row", "score"):
            assert_equal(f"template scene {stage} {field}", getattr(sg[stage], field).cpu(),
                         getattr(sc[stage], field))
    birth = sg["birth"]
    pc, pg = cpu.state.particles, gpu.state.particles
    assert_equal("template scene status", pg.status.cpu(), pc.status)
    for f in ("px", "py", "pz", "weight"):
        assert_close(f"template scene {f}", getattr(pg, f).cpu(), getattr(pc, f))
    n_guessed = int((pc.status == STATUS_GUESSED_BORN).sum())
    if n_guessed == 0:
        raise AssertionError("template scene: no GUESSED_BORN particle")
    print(f"[tiny] template scene: birth sweep gate row {birth.gate_row.tolist()}, score "
          f"{float(birth.score):.6f} on both devices; {n_guessed} GUESSED_BORN particles "
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


class Sweep(NamedTuple):
    """A frame's sweeps of one template stage, from its record on the card
    (``template_engine.SweepRecord``): how many, and the gate row and score
    of the last."""

    stage: str
    n: int
    gate_row: list
    score: float


def sweep_counts(dsp) -> dict:
    """The sweeps each template stage of ``dsp`` has run ({} without
    template mode)."""
    if dsp._templates is None or dsp._templates.records is None:
        return {}
    return {stage: int(r.count) for stage, r in dsp._templates.records.items()}


def sweeps_of_frame(dsp, before: dict) -> list:
    """The ``Sweep`` of each stage whose count rose since ``before``
    (``sweep_counts`` before the frame)."""
    out = []
    for stage, n in sweep_counts(dsp).items():
        if n > before.get(stage, 0):
            r = dsp._templates.records[stage]
            out.append(Sweep(stage, n - before.get(stage, 0), r.gate_row.tolist(), float(r.score)))
    return out


def drive_main_path(name, cfg, params, synth, counters, card, warmup=3, frames=5,
                    template_path=None):
    """SemanticDSPMap.update() on ``cfg`` for warm-up + timed frames, with
    the launch counts set to 0 just before and read just after: the frame
    kernels once a frame, the merge kernel once per ``_insert_core``
    (``hold_runs``; the captured graphs hold ``inserts_a_frame`` launches
    of it, which every replay runs).  With
    ``template_path`` the map loads that bank and every frame that ran a
    template sweep is printed (``sweeps_of_frame``).  Returns (launches,
    median ms, map, per-frame ms, [(frame, sweep, GUESSED_BORN count after
    it)])."""
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
        counts = sweep_counts(dsp)
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
        new = sweeps_of_frame(dsp, counts)
        if new:
            guessed = int((dsp.state.particles.status == STATUS_GUESSED_BORN).sum())
            for sw in new:
                sweeps.append((t, sw, guessed))
                print(f"[{name}] frame {t}: {sw.stage} sweep, gate row {sw.gate_row} "
                      "(valid, rematch, birth, track, label, points, x mm, y mm), "
                      f"score {sw.score:.6f}; {guessed} GUESSED_BORN particles after the frame")
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
    template = template_path is not None
    hold_runs(name, launches, n, template)
    in_graphs = sum(g.launches[MERGE_FN] for g in dsp._static.graphs.values())
    if in_graphs != inserts_a_frame(template):
        raise AssertionError(f"{name}: the captured frame holds {in_graphs} merge launches")
    print(f"[{name}] the merge kernel ran {launches[MERGE_FN]} times in {n} frames: once per "
          f"_insert_core ({in_graphs} in the captured frame)")
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
        self.calls, self.kwargs, self.launches = [], [], 0

    def __call__(self, *args, **kwargs):
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
        self.kwargs.append(kwargs)
        return self.fn(*args, **kwargs)

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
    timed; and the arguments of its two merges (the moving-object cleanup's
    and birth's working sets) through the merge kernel.  With ``other`` (a
    build of another version of the sources) the two versions are timed in
    turns.  Returns the numbers."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.map import build_frame_step, unpack_frame
    from semantic_dsp_map_tpu_torch.ops import birth, observe_cuda, phd_cuda, render_cuda
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
          CallRecorder(render_cuda, "render_core_cuda") as rec_r,
          CallRecorder(birth, "merge_blocks") as rec_m):
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
    del p, vst, vax

    # Birth's merge on the frame's two working sets: the moving-object
    # cleanup's re-insert, then the birth.
    if len(rec_m.calls) != 2:
        raise AssertionError(f"real frame: {len(rec_m.calls)} merges, want 2")
    for label, args in zip(("move_cleanup", "birth"), rec_m.calls):
        out.setdefault("merge", {})[label] = check_merge_once(f"real frame {t} {label}", *args,
                                                              card)
    return out


def frame_cloud(dsp, synth, t):
    """Frame ``t`` of ``synth`` on the card: (its masks, the unpacked frame,
    its labeled cloud)."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.map import unpack_frame
    from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices
    from semantic_dsp_map_tpu_torch.ops.projection import generate_labeled_cloud

    cfg = dsp.cfg
    depth, masks, pos, quat = synth(cfg, t, MaskKpts)
    buf = torch.from_numpy(pack_frame(cfg, dsp.registry, depth, masks, pos, quat, 0.0)).cuda()
    f = unpack_frame(cfg, dsp._static_table, buf)
    r_wc, t_wc, _, _ = camera_matrices(f.cam_pos, f.cam_quat)
    cloud = generate_labeled_cloud(cfg, dsp.params, f.depth, f.track_raster, f.track_label_table,
                                   r_wc, t_wc, dsp.registry.max_movable_instance_id)
    return masks, f, cloud


def time_template_parts(dsp, synth, t):
    """The template work that a replayed frame runs whatever its slots do,
    on the map's state after its path and frame ``t``'s cloud, each part
    alone (CUDA events, device-only, median of 10): the two ``_top_rows``
    sorts; the rematch and birth stages' inserts with no valid candidate
    (which change nothing); the birth's normals.  The gate's and the delete
    pass's kernels are timed by [templates] (``check_template_kernels``)
    alone.  Then all of it: the gate and both stages, on stages of their
    own, fed a gate with no eligible row, captured into a CUDA graph (their
    three IF nodes included) and replayed.  Returns {part: ms}."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch import step_graph
    from semantic_dsp_map_tpu_torch.ops.birth import _insert_core
    from semantic_dsp_map_tpu_torch.ops.templates_cuda import template_gate_cuda
    from semantic_dsp_map_tpu_torch.template_engine import (
        GUESSED_BIRTH_COPIES, RM_MAX, TB_MAX, TM_INSERT_BLOCKS, TemplateEngine, _candidates,
        _top_rows,
    )

    cfg, eng, state = dsp.cfg, dsp._templates, dsp.state
    _, f, cloud = frame_cloud(dsp, synth, t)
    p, scroll, gt = state.particles, state.scroll, state.global_time
    car = dsp.registry.label_to_id["Car"]
    no = torch.zeros_like(state.objects.valid)
    objects = dataclasses.replace(state.objects, to_match_previous=no, to_match_templates=no)
    gate = template_gate_cuda(car, objects, cloud)
    Pt = eng.grid.max_template_points
    gen = torch.Generator(device="cuda").manual_seed(0)

    def insert(n):
        pos = torch.zeros((n, 3), dtype=torch.float32, device="cuda")
        full = torch.zeros(n, dtype=torch.int32, device="cuda")
        cand = _candidates(pos, torch.zeros(n, dtype=torch.bool, device="cuda"), full, full,
                           0.2, gt)
        return _insert_core(cfg, p, scroll, cand, resample_targets=False,
                            max_target_blocks=TM_INSERT_BLOCKS).block_overflow

    n_birth = TB_MAX * Pt * GUESSED_BIRTH_COPIES
    parts = {
        "top_rows": lambda: (_top_rows(gate[:, 1] == 1, RM_MAX), _top_rows(gate[:, 2] == 1, TB_MAX)),
        "rematch_insert": lambda: insert(RM_MAX * Pt),
        "birth_insert": lambda: insert(n_birth),
        "normals": lambda: torch.randn((n_birth, 3), generator=gen, device="cuda"),
    }
    ms = {name: cuda_ms(fn, 10, queued=True) for name, fn in parts.items()}

    own = TemplateEngine(cfg, dsp.params, dsp.registry, bank=eng.bank, grid=eng.grid)
    stages = own.stages("cuda")

    def both():
        g = stages.gate(objects, cloud)
        _, ov = stages.rematch(p, scroll, cloud, f.cam_pos, g, gt)
        _, _, ov_b = stages.birth(p, scroll, objects, cloud, f.cam_pos, g, gt, gen)
        return ov + ov_b

    both()  # eager: every branch runs once before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    capture = step_graph.Capture(graph)
    with step_graph.capturing(capture):
        both()
    ms["stages_in_a_graph"] = cuda_ms(graph.replay, 10, queued=True)
    if any(int(r.count) for r in stages.records.values()):
        raise AssertionError("template parts: a branch ran on a gate with no eligible row")
    return ms


def gate_bytes(objects, cloud):
    """(bytes, pixels) of what the template gate has to move: every pixel's
    track (4 B) and validity (1 B); x and y of each pixel that some valid
    row takes, as the 32-byte sectors that hold bytes [12 p, 12 p + 8) of
    the interleaved f32[H*W, 3] positions, each sector counted once over
    the set of those pixels (a car's pixels are contiguous, so neighbours
    share sectors: about 12 B a pixel), not once a row; each object row's
    five flags, track id and label (13 B) and its eight i32 columns written
    (32 B).  ``pixels`` counts those distinct pixels."""
    import torch

    ids = objects.track_id[objects.valid]
    hit = cloud.valid.reshape(-1) & torch.isin(cloud.track.reshape(-1), ids)
    first = 12 * torch.nonzero(hit).squeeze(1)
    sectors = torch.unique(torch.cat([first // 32, (first + 7) // 32])).numel()
    rows = objects.valid.shape[0]
    return cloud.track.numel() * 5 + 32 * sectors + rows * (13 + 32), int(first.numel())


def check_template_kernels(card, frames=4, reps=20):
    """[templates] (``--phase templates``): the two kernels of
    csrc/templates.cu at the template cell's shapes, on a VKITTI2 template
    map after ``frames`` frames of [graph]'s template scene (its object table
    of 64 rows, frame ``frames``' cloud of 1242 x 375 pixels, its store of
    58,720,256 slots): each against its plain version on the card, bit for
    bit, and timed beside it and beside its bound, device-only (the launch
    queued behind a spin, median of ``reps``) and inside a CUDA graph.  The
    gate's bound counts the bytes of ``gate_bytes`` and, beside it, every
    pixel's position too (2.4 us); the delete's, with no slot good, nothing
    but its launch, with one good, the store's track and a byte of status a
    slot it deletes.  Returns the report."""
    import torch
    from semantic_dsp_map_tpu_torch import (
        FilterParams, MaskKpts, SemanticDSPMap, virtual_kitti2_config,
    )
    from semantic_dsp_map_tpu_torch.ops.templates_cuda import (
        delete_matched_cuda, template_gate_cuda,
    )
    from semantic_dsp_map_tpu_torch.template_engine import delete_matched_plain, template_gate

    cfg = virtual_kitti2_config()
    dsp = SemanticDSPMap(cfg, FilterParams(**bench_scenes().TPL_PARAMS), device="cuda")
    dsp.set_template_path(str(TEMPLATES))
    for t in range(frames):
        dsp.update(*late_template_frame(cfg, t, MaskKpts), 0.1 * t)
    _, _, cloud = frame_cloud(dsp, late_template_frame, frames)
    objects, p = dsp.state.objects, dsp.state.particles
    car = dsp.registry.label_to_id["Car"]
    out = {"card": card}

    gate = template_gate_cuda(car, objects, cloud)
    assert_equal("[templates] gate", gate, template_gate(car, objects, cloud))
    n_pix = cloud.track.numel()
    taken = int(gate[:, 5].sum())
    need, matched = gate_bytes(objects, cloud)
    row = {"rows": int(gate.shape[0]), "valid_rows": int(gate[:, 0].sum()), "pixels": n_pix,
           "points_taken": taken, "pixels_matched": matched, "bytes": need,
           "ms": cuda_ms(lambda: template_gate_cuda(car, objects, cloud), reps, queued=True),
           "in_graph_ms": graph_ms(lambda: template_gate_cuda(car, objects, cloud)),
           "plain_ms": cuda_ms(lambda: template_gate(car, objects, cloud), reps, queued=True),
           "plain_in_graph_ms": graph_ms(lambda: template_gate(car, objects, cloud)),
           **bound(need),
           "bound_all_positions_ms": bound(n_pix * (4 + 1 + 12))["bound_ms"]}
    note = cache_note(row, "", cloud.track, cloud.valid, cloud.pos)
    print(f"[templates] gate [{row['rows']}, {n_pix}] ({row['valid_rows']} valid rows, "
          f"{taken} points taken, {matched} distinct pixels, {need} bytes): kernel {row['ms']:.4f} ms device-only, "
          f"{row['in_graph_ms']:.4f} in a graph; bound {row['bound_ms']:.4f} ms "
          f"({row['bound_all_positions_ms']:.4f} reading every position); plain "
          f"{row['plain_ms']:.4f} ms, {row['plain_in_graph_ms']:.4f} in a graph; bit-equal{note}")
    out["gate"] = row

    valid = gate[:, 0] == 1
    counts = torch.where(valid, gate[:, 5], -1)
    tid = torch.stack([gate[int(counts.argmax()), 3],
                       torch.tensor(2 ** 30, dtype=torch.int32, device="cuda")])
    status0 = p.status.clone()
    work = status0.clone()
    for name, flags in (("none", (False, False)), ("one", (True, False))):
        good = torch.tensor(flags, device="cuda")
        delete_matched_cuda(p.track, work, good, tid)
        plain = status0.clone()
        delete_matched_plain(p.track, plain, good, tid)
        assert_equal(f"[templates] delete {name}", work, plain)
        deleted = int((work != status0).sum())
        reset = lambda: work.copy_(status0)
        row = {"slots": p.track.numel(), "slots_of_id": int((p.track == tid[0]).sum()) if flags[0]
               else 0, "changed": deleted,
               "ms": cuda_ms(lambda: delete_matched_cuda(p.track, work, good, tid), reps,
                             queued=True, setup=reset),
               "in_graph_ms": graph_ms(lambda: delete_matched_cuda(p.track, work, good, tid)),
               "plain_ms": cuda_ms(lambda: delete_matched_plain(p.track, work, good, tid), reps,
                                   queued=True, setup=reset),
               "plain_in_graph_ms": graph_ms(
                   lambda: delete_matched_plain(p.track, work, good, tid)),
               **bound(nbytes(p.track) + deleted if flags[0] else 0)}
        reset()
        print(f"[templates] delete, {name} good ({row['slots_of_id']} slots of the id, "
              f"{deleted} changed): kernel {row['ms']:.4f} ms device-only, "
              f"{row['in_graph_ms']:.4f} in a graph; bound {row['bound_ms']:.4f} ms; plain "
              f"{row['plain_ms']:.4f} ms, {row['plain_in_graph_ms']:.4f} in a graph; bit-equal")
        out[f"delete_{name}"] = row
    assert_equal("[templates] the store's status", p.status, status0)
    print(f"[templates] {card}")
    return out


def time_template_sweep(dsp, synth, t):
    """The birth sweep of frame ``t`` alone: the car's cloud rebuilt from the
    frame, compacted and swept against the bank (template_match_bank, FS
    variant), timed on the card; its score must equal the main path's."""
    import torch
    from semantic_dsp_map_tpu_torch.ops.templates import template_match_bank
    from semantic_dsp_map_tpu_torch.template_engine import _extract_track_points

    eng = dsp._templates
    masks, f, cloud = frame_cloud(dsp, synth, t)
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


#: The wrapper of birth's merge kernel (ops/birth_cuda.py), by name.
MERGE_FN = "merge_blocks_cuda"
#: The wrappers of template mode's every-frame kernels (csrc/templates.cu).
TEMPLATE_FNS = ("template_gate_cuda", "delete_matched_cuda")


def inserts_a_frame(template=False) -> int:
    """``_insert_core`` calls a frame, each one launch of birth's merge
    kernel: birth's and the moving-object cleanup's, and with a template
    bank the rematch and birth stages' too (outside the stages'
    conditional nodes: they insert every frame, nothing valid where no
    branch ran)."""
    return 4 if template else 2


def runs_a_frame(fname, template=False) -> int:
    """How often the kernel of wrapper ``fname`` runs a frame: a frame
    kernel once, birth's merge once per ``_insert_core``, the template
    gate and rematch's delete once with a template bank and never without."""
    if fname in TEMPLATE_FNS:
        return int(template)
    return inserts_a_frame(template) if fname == MERGE_FN else 1


def hold_runs(tag, launches, frames, template=False):
    """Raise unless each kernel of ``launches`` ran ``runs_a_frame`` times
    in each of ``frames`` frames."""
    want = {f: frames * runs_a_frame(f, template) for f in launches}
    if launches != want:
        raise AssertionError(f"{tag}: kernel runs {launches} in {frames} frames, want {want}")


def drive_replay(counters, card, n_frames=13, drop_first=2):
    """The replay path: ``n_frames`` VKITTI2 frames written with
    datasets.save_npz_frame, then replay.main on them with the default
    device (the card) and default runtime parameters, PLY clouds every 5
    mapped frames.  Every mapped frame must launch each frame kernel once
    and birth's merge once per ``_insert_core`` (``hold_runs``);
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
        hold_runs("replay", launches, mapped)
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
    kernel once and birth's merge once per ``_insert_core``.  Returns (launches, report)."""
    from semantic_dsp_map_tpu_torch.tools import soak

    out = REPO / "chiprun_out" / "SOAK_KITTI360.json"
    reset_launches(counters)
    report = soak.main(["--frames", str(frames), "--out", str(out)])
    launches = read_launches(counters)
    hold_runs("soak", launches, frames + soak.RESUME_FRAMES)
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
    from semantic_dsp_map_tpu_torch import (
        FilterParams, MaskKpts, SemanticDSPMap, virtual_kitti2_config,
    )

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
        hold_runs(f"expected {name}", launches, n)
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
    once per frame (and all cells together birth's merge once per
    ``_insert_core``), leave occupied voxels and no NaN weight; the template
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
    frames_of = {}
    for name, cell in cells.items():
        n = frames_of[name] = cell["warmup"] + len(cell["runs"]) * cell["frames"]
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
    want = {f: sum(n * runs_a_frame(f, name == "vkitti2_template")
                   for name, n in frames_of.items()) for f in launches}
    if launches != want:
        raise AssertionError(f"bench: kernel runs {launches} in {frames_of} frames, want {want}")
    tpl = cells["vkitti2_template"]
    if tpl["template_sweeps"].get("birth", 0) < 1 or tpl["guessed_born_in_warmup"] <= 0:
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
    print(f"[bench] four cells, {sum(frames_of.values())} frames, launches {launches}; template cell: sweeps "
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


def movable_bound(cfg, status, stamp, vax):
    """The movable scan's bound on this store, counting what these inputs
    need: the status of every slot (1 B), the output byte of every voxel,
    the scroll stamp (4 B) of the voxels with a status set, the stamp (4 B)
    of the slots with a status set and the track (4 B) of the live ones, at
    the memory rate.  Returns (bound, slots with a status, live slots,
    voxels with a status)."""
    K = cfg.slots_per_voxel
    has_status = status != 0
    n_set = int(has_status.sum())
    n_vox = int(has_status.view(-1, K).any(1).sum())
    n_alive = int((has_status & (stamp >= vax.repeat_interleave(K))).sum())
    return bound(status.numel() + vax.numel() + 4 * (n_vox + n_set + n_alive)), n_set, n_alive, n_vox


def profile_frame(run):
    """torch.profiler around one call of ``run`` (a frame, ended by a
    synchronize): (host API calls, device ms by kernel name, device busy ms,
    wall ms, kernel launches, host API calls by name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e3
    import collections

    api = collections.Counter(e.name for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CPU
                              and e.name.startswith("cu"))
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {e.key: (e.self_device_time_total / 1e3, e.count) for e in device}
    busy = sum(ms for ms, _ in by_name.values())
    return (sum(api.values()), by_name, busy, wall, sum(n for _, n in by_name.values()),
            dict(api.most_common()))


def top_ops(by_name, n=15):
    """The ``n`` ops of a profiled frame (``profile_frame``'s device ms by
    kernel name) with the most device ms: [{op, ms, launches}]."""
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"op": op, "ms": ms, "launches": count} for op, (ms, count) in rows]


def top_ops_line(rows) -> str:
    return "; ".join(f"{r['ms']:.4f} ms x{r['launches']} {r['op'][:100]}" for r in rows)


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


#: [graph]'s template scene (``late_template_frame``): the car of
#: ``scenes.synth_template_frame`` first shows on frame TPL_LATE_CAR, and its
#: keypoints are withheld on frame TPL_LOST, when it moves but has no
#: velocity yet.  Both are replayed frames: the birth branch runs on the
#: first, the rematch branch on the second, and no branch on the others.
TPL_LATE_CAR, TPL_LOST = 2, 5


def late_template_frame(cfg, t, mask_cls):
    """Frame t of [graph]'s template scene (see TPL_LATE_CAR): before
    TPL_LATE_CAR the car's box is there but untracked (static-labelled)."""
    depth, masks, pos, quat = bench_scenes().synth_vkitti2_frame(
        cfg, t, mask_cls, car_h_div=5, car_w_div=14, kpts=t != TPL_LOST)
    return depth, masks if t >= TPL_LATE_CAR else masks[:1], pos, quat


def records_differ(a, b) -> list:
    """Names of the sweep-record fields (by stage) of two template engines
    that are not bit-equal."""
    import torch

    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return [f"sweeps.{stage}.{f}" for stage in a
            for f, x, y in zip(a[stage]._fields, a[stage], b[stage])
            if not torch.equal(bits(x), bits(y))]


def drive_graph(name, cfg, params, synth, counters, card, frames=10, template_path=None,
                profile_at=()):
    """[graph]: ``SemanticDSPMap.update()`` (frame 0 eager, frame 1 captured
    into CUDA graphs and replayed, replays after; where the superpoint refit
    runs, two graphs around the eager SVD) in turns with the eager step
    (``build_frame_step``'s parts on a state of its own, fed the same packed
    frame: ``pack_frame``, the copy and the unpack included; on frame 1 the
    parts the card captures under the sync debug mode "error", the SVD
    outside it), ``frames`` frames from one seed, the presets' noise on:
    state (the generator's seed and offset too), render and counters
    bit-equal every frame.  The bridge (the SVD between the graphs) is timed
    on its own in the graph frames: host ms from its call to its return and
    device ms between events around it, after a synchronize whose host ms
    is kept too (the SVD waits for the first graph in any case: it reads to
    the host).  Then one more
    frame of each under torch.profiler: host API calls a frame (by name),
    device busy share, and the five kernels' device time inside the replay.
    With ``template_path`` both load that bank (the eager step's template
    stages are its own, with their own sweep records, which must equal the
    map's every frame) and the frames on which a template branch ran are
    listed; the graph frames of ``profile_at`` run under torch.profiler
    too (a replay with a taken branch).  Medians leave those frames out.
    Returns the numbers."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts, SemanticDSPMap, step_graph
    from semantic_dsp_map_tpu_torch.frontend import pack_frame
    from semantic_dsp_map_tpu_torch.map import build_frame_stages, unpack_frame
    from semantic_dsp_map_tpu_torch.objects import refit_svd
    from semantic_dsp_map_tpu_torch.ops import codecs
    from semantic_dsp_map_tpu_torch.state import init_map_state
    from semantic_dsp_map_tpu_torch.template_engine import TemplateEngine

    reset_launches(counters)
    dsp = SemanticDSPMap(cfg, params, device="cuda")
    eager_templates = None
    if template_path is not None:
        dsp.set_template_path(str(template_path))
        engine = TemplateEngine(cfg, params, dsp.registry)
        engine.set_template_path(str(template_path))
        eager_templates = engine.stages("cuda")
    stages = build_frame_stages(cfg, params, dsp.registry, eager_templates)
    box = {"state": init_map_state(cfg, 0, "cuda")}
    scenes = [synth(cfg, t, MaskKpts) for t in range(frames + 1)]
    split = step_graph.split_at_refit(cfg)

    def graph_frame(t):
        return dsp.update(*scenes[t], 0.1 * t)

    def eager_frame(t):
        # build_frame_step's step, in its parts; on frame 1 the parts the
        # card captures run under the sync debug mode "error", which raises
        # on an op that synchronizes with the host; the SVD between them
        # runs outside it.
        buf = pack_frame(cfg, dsp.registry, *scenes[t], 0.1 * t)
        f = unpack_frame(cfg, dsp._static_table, torch.from_numpy(buf).cuda())
        checked = (lambda: contextlib.nullcontext()) if t != 1 else sync_debug_errors
        state = box["state"]
        if split:
            with checked():
                fit = stages.objects_fit(state, f)
            uv = refit_svd(fit)
        with checked():
            objects = stages.objects_finish(fit, *uv) if split else stages.objects(state, f)
            box["state"], result, diag = stages.rest(state, f, objects)
        return result, diag

    bridge = {"wait_ms": [], "host_ms": [], "events": []}

    def timed_bridge(fit):
        w0 = time.perf_counter()
        torch.cuda.synchronize()
        bridge["wait_ms"].append((time.perf_counter() - w0) * 1e3)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        w0 = time.perf_counter()
        type(dsp._static)._bridge(dsp._static, fit)
        bridge["host_ms"].append((time.perf_counter() - w0) * 1e3)
        b.record()
        bridge["events"].append((a, b))

    modes = {"graph": graph_frame, "eager": eager_frame}
    ms = {m: [] for m in modes}
    wall = {m: [] for m in modes}
    work = {m: [] for m in modes}
    branches, taken = {}, {}  # frame -> [Sweep]; frame -> its profile
    for t in range(frames):
        if t == 1 and split:
            dsp._static._bridge = timed_bridge
        out = {}
        counts = sweep_counts(dsp)
        for mode in (("graph", "eager") if t % 2 == 0 else ("eager", "graph")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            w0 = time.perf_counter()
            a.record()
            if mode == "graph" and t in profile_at:
                taken[t] = profile_frame(lambda: out.__setitem__("graph", graph_frame(t)))
            else:
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
        if eager_templates is not None:
            parted += records_differ(dsp._templates.records, eager_templates.records)
            branches[t] = sweeps_of_frame(dsp, counts)
        if parted:
            raise AssertionError(f"[graph] {name} frame {t}: the graph parts from the eager step "
                                 f"in {parted}")
        print(f"[graph] {name} frame {t}: graph {ms['graph'][-1]:.3f} ms (host "
              f"{wall['graph'][-1]:.3f}), eager {ms['eager'][-1]:.3f} ms (host "
              f"{wall['eager'][-1]:.3f}); state, render and counters bit-equal; diag {dgd}"
              + (f"; bridge host {bridge['host_ms'][-1]:.3f} ms, device "
                 f"{bridge['events'][-1][0].elapsed_time(bridge['events'][-1][1]):.3f} ms"
                 if split and t >= 1 else "")
              + ("; the eager frame's captured parts made no sync under the debug mode" if t == 1
                 else "")
              + ("".join(f"; {sw.stage} branch ran: gate row {sw.gate_row}, score {sw.score:.6f}"
                         for sw in branches[t]) + "; sweep records bit-equal"
                 if eager_templates is not None else ""))
    launches = read_launches(counters)
    captured, replayed = dict(step_graph.captured), dict(step_graph.replayed)
    # Each frame: the map's kernels (eager on frame 0, replayed after) and
    # the eager step's.
    template = template_path is not None
    hold_runs(f"[graph] {name}", launches, 2 * frames, template)
    if any(replayed.get(f, 0) != (frames - 1) * runs_a_frame(f, template)
           or captured.get(f, 0) != runs_a_frame(f, template) for f in launches):
        raise AssertionError(f"[graph] {name}: launches {launches} in {frames} frames of each, "
                             f"captured {captured}, replayed {replayed}")
    want = {("packed", "fit"), ("packed", "finish")} if split else {("packed", "step")}
    if set(dsp._static.graphs) != want or dsp._static.split != split:
        raise AssertionError(f"[graph] {name}: graphs {list(dsp._static.graphs)}, want {want}")
    if split and any(dsp._static.graphs["packed", "fit"].launches.values()):
        raise AssertionError(f"[graph] {name}: frame kernels in the fit graph "
                             f"{dsp._static.graphs['packed', 'fit'].launches}")
    bridge_ms = {}
    if split:
        del dsp._static._bridge  # the profiled frame runs the bridge untimed
        device = [a.elapsed_time(b) for a, b in bridge["events"]]
        bridge_ms = {"host_ms": bridge["host_ms"], "device_ms": device,
                     "wait_ms": bridge["wait_ms"],
                     "median_host_ms": float(np.median(bridge["host_ms"][1:])),
                     "median_device_ms": float(np.median(device[1:])),
                     "median_wait_ms": float(np.median(bridge["wait_ms"][1:]))}

    t = frames
    p = dsp.state.particles
    bound_m, n_set, n_alive, _ = movable_bound(
        cfg, p.status, p.stamp, codecs.axis_stamps_per_voxel(cfg, dsp.state.scroll))
    prof = {"graph": profile_frame(lambda: graph_frame(t)),
            "eager": profile_frame(lambda: eager_frame(t))}
    parted = states_differ(dsp.state, box["state"])
    if parted:
        raise AssertionError(f"[graph] {name} profiled frame: parts in {parted}")
    api_g, kernels_g, busy_g, wall_g, n_g, api_by_g = prof["graph"]
    api_e, _, busy_e, wall_e, n_e, api_by_e = prof["eager"]
    in_graph = {}
    for key, kname in FRAME_KERNEL_NAMES:
        hits = [(ms_, n) for k, (ms_, n) in kernels_g.items() if kname in k]
        if len(hits) != 1 or hits[0][1] != 1:
            raise AssertionError(f"[graph] {name}: {kname} in the profiled replay: {hits}")
        in_graph[key] = hits[0][0]
    # Medians over the replayed frames 2-9 on which no template branch ran
    # (all of them outside template mode).
    timed = [t for t in range(2, frames) if not branches.get(t) and t not in profile_at]
    med = {m: float(np.median([ms[m][t] for t in timed])) for m in modes}
    med_wall = {m: float(np.median([wall[m][t] for t in timed])) for m in modes}
    peak = {"graph_capture": work["graph"][1], "graph_replay": max(work["graph"][2:]),
            "eager": max(work["eager"]), "graph_pool_reserved": torch.cuda.memory_reserved()}
    objects = "in the graph (two parts around the SVD)" if split else "in the graph"
    print(f"[graph] {name}: grid {cfg.num_voxels} voxels x K={cfg.slots_per_voxel}, image "
          f"{cfg.width}x{cfg.height}, object layer {objects}; per-frame medians over frames "
          f"{timed}, in turns: graph {med['graph']:.3f} ms (host {med_wall['graph']:.3f}), "
          f"eager {med['eager']:.3f} ms (host {med_wall['eager']:.3f}), ratio "
          f"{med['eager'] / med['graph']:.2f}x ({card})")
    print(f"[graph] {name}: host API calls a frame: graph {api_g}, eager {api_e}; device kernels "
          f"a frame: graph {n_g}, eager {n_e}; device busy: graph {busy_g:.3f} of {wall_g:.3f} ms "
          f"({100 * busy_g / wall_g:.1f}%), eager {busy_e:.3f} of {wall_e:.3f} ms "
          f"({100 * busy_e / wall_e:.1f}%) (profiled frame {t})")
    print(f"[graph] {name}: host API calls of the graph frame by name: {api_by_g}; of the eager "
          f"frame, the first ten: {dict(list(api_by_e.items())[:10])}")
    if split:
        print(f"[graph] {name}: the bridge (the eager SVD between the two graphs), medians over "
              f"frames 2-{frames - 1}: host {bridge_ms['median_host_ms']:.3f} ms from its call "
              f"to its return, device {bridge_ms['median_device_ms']:.3f} ms between events "
              f"around it, the device idle before it; the host waited "
              f"{bridge_ms['median_wait_ms']:.3f} ms for the fit graph before it ({card})")
    else:
        print(f"[graph] {name}: one graph a frame, no bridge")
    print(f"[graph] {name}: memory a frame takes beyond the resident states: capture "
          f"{peak['graph_capture']} bytes, replay {peak['graph_replay']} bytes, eager "
          f"{peak['eager']} bytes; reserved after {peak['graph_pool_reserved']} bytes")
    print(f"[graph] {name}: kernels inside the replay (ms, profiler): "
          + ", ".join(f"{k} {v:.4f}" for k, v in in_graph.items())
          + f"; movable scan bound on this store {bound_m['bound_ms']:.4f} ms by bytes ({n_set} "
          f"slots with a status, {n_alive} alive), share "
          f"{bound_m['bound_ms'] / in_graph['movable_voxels']:.3f} ({card})")
    ops_g = top_ops(kernels_g)
    print(f"[graph] {name}: the top {len(ops_g)} ops of the replayed frame {t} by device ms "
          f"(profiler; ms, launches, op): {top_ops_line(ops_g)} ({card})")
    print(f"[graph] {name}: launches {launches} ({frames} frames each), captured {captured}, "
          f"replayed {replayed}")
    template = {}
    if eager_templates is not None:
        ran = {t: [sw.stage for sw in sws] for t, sws in branches.items() if sws}
        idle = [t for t in range(2, frames) if t not in ran]
        if any(t not in ran for t in profile_at) or not idle:
            raise AssertionError(f"[graph] {name}: template branches ran on frames {ran}; "
                                 f"profiled {list(profile_at)}, no branch on {idle}")
        template = {"branches": ran, "idle_frames": idle,
                    "taken": {t: {"api_calls": taken[t][0], "device_busy_ms": taken[t][2],
                                  "wall_ms": taken[t][3], "device_kernels": taken[t][4],
                                  "branches": ran[t]} for t in profile_at},
                    "idle_device_busy_ms": busy_g, "idle_api_calls": api_g,
                    "graph_ms_by_frame": ms["graph"], "eager_ms_by_frame": ms["eager"]}
        for t in profile_at:
            api_t, _, busy_t, wall_t, n_t, _ = taken[t]
            print(f"[graph] {name}: the replayed frame {t} with a taken {'+'.join(ran[t])} branch: "
                  f"device busy {busy_t:.3f} of {wall_t:.3f} ms, {n_t} device kernels, {api_t} "
                  f"host API calls (profiler); a replayed frame with no branch (frame {frames}): "
                  f"device busy {busy_g:.3f} ms, {n_g} device kernels, {api_g} host API calls "
                  f"({card})")
        print(f"[graph] {name}: template branches ran on frames {ran} and on no other; "
              f"replayed frames with no branch: {idle}; sweep records bit-equal every frame")
    del dsp, box
    return {"graph_ms": ms["graph"], "eager_ms": ms["eager"], "graph_wall_ms": wall["graph"],
            "eager_wall_ms": wall["eager"], "median_ms": med, "median_wall_ms": med_wall,
            "api_calls": {"graph": api_g, "eager": api_e},
            "api_calls_by_name": {"graph": api_by_g, "eager": api_by_e}, "bridge": bridge_ms,
            "device_kernels": {"graph": n_g, "eager": n_e},
            "device_busy_ms": {"graph": busy_g, "eager": busy_e},
            "profiled_wall_ms": {"graph": wall_g, "eager": wall_e}, "memory_bytes": peak,
            "kernel_ms_in_replay": in_graph, "top_ops": ops_g, "movable_bound": bound_m,
            "movable_slots": {"status_set": n_set, "alive": n_alive}, "object_layer": objects,
            "launches": launches, "template": template}


# ---------------------------------------------------------------------------
# [scan]: the segment scans, the torch.cummax form against the package's
# ---------------------------------------------------------------------------

#: [scan]'s start densities (the share of elements that start a segment;
#: element 0 always does) and the one its times are taken at.
SCAN_DENSITIES = (0.0, 0.001, 0.01, 0.1, 0.5, 1.0)
SCAN_TIMED_DENSITY = 0.1
#: [scan]'s largest length: V*K at VKITTI2, prim_bench1's cummax line.
SCAN_BIG = 58_720_256
#: The two maps of [scan]'s frames: built as the package builds them, and
#: built and captured with the scans in their torch.cummax form.
SCAN_WAYS = ("new", "cummax")


def segment_start_cummax(is_start):
    """The port's ``ops.blocks.segment_start_index`` as it was before: a
    running max of the starts' indices (``torch.cummax``).  [scan]'s plain
    reference."""
    import torch

    idx = torch.arange(is_start.shape[0], device=is_start.device)
    return torch.cummax(torch.where(is_start, idx, 0), dim=0).values


def group_rank_cummax(sorted_key):
    """``ops.blocks.group_rank`` over ``segment_start_cummax``."""
    import torch

    n = sorted_key.shape[0]
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_key.device)
    is_start[1:] = sorted_key[1:] != sorted_key[:-1]
    return torch.arange(n, device=sorted_key.device) - segment_start_cummax(is_start)


def segment_cumsum_cummax(values, is_start):
    """observe's count of visible entries within a pixel's run as it was
    before: the running count less its value before the run's start, the
    start by ``segment_start_cummax``."""
    import torch

    start = segment_start_cummax(is_start)
    cs = torch.cumsum(values, 0)
    return cs - (cs[start] - values[start])


@contextlib.contextmanager
def cummax_scans(calls):
    """Inside the block the modules that bind the segment scans
    (``ops.blocks``, ``ops.observe``, ``ops.birth``, ``parallel.shard_step``)
    hold the ``torch.cummax`` forms above, and ``calls`` (a Counter) counts
    each call by (function, length).  A step built and captured inside the
    block runs the old form in every replay.  Nothing of the package
    changes outside the block."""
    from semantic_dsp_map_tpu_torch.ops import birth, blocks, observe
    from semantic_dsp_map_tpu_torch.parallel import shard_step

    def counted(name, fn):
        def run(x, *rest):
            calls[name, x.shape[0]] += 1
            return fn(x, *rest)
        return run

    patches = [
        (blocks, "segment_start_index", counted("segment_start_index", segment_start_cummax)),
        (observe, "segment_cumsum", counted("segment_cumsum", segment_cumsum_cummax))]
    patches += [(m, "group_rank", counted("group_rank", group_rank_cummax))
                for m in (blocks, birth, shard_step)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, fn in patches:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def check_scans(lengths, card, reps=20):
    """[scan]'s primitives at each length of ``lengths`` (length -> where
    the frame runs it): ``segment_start_index``, ``group_rank`` and
    ``segment_cumsum`` of ``ops.blocks`` against their ``torch.cummax``
    forms, integers equal at every start density of SCAN_DENSITIES (keys
    sorted, runs as the starts say); then, at SCAN_TIMED_DENSITY, each
    timed with CUDA events (with the launches and with them queued behind
    a device-side spin) beside its cummax form and ``torch.cumsum`` on the
    same length, and beside its bound: the bytes it must move at the
    memory rate (the bool starts 1 byte an element, int64 keys, values and
    results 8), and ``segment_start_index``'s four parts alone
    (device-only).  Below SCAN_BIG the three also run in one CUDA graph,
    checked against the cummax forms after a replay and timed inside a
    graph.  Returns a row a length."""
    import torch
    from semantic_dsp_map_tpu_torch.ops import blocks

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    names = ("segment_start_index", "group_rank", "segment_cumsum")
    rows = []
    for n, used_by in sorted(lengths.items()):
        row = {"n": n, "used_by": used_by, "densities": list(SCAN_DENSITIES)}
        for d in SCAN_DENSITIES:
            s = torch.rand(n, generator=gen, device="cuda") < d
            s[0] = True
            keys = torch.cumsum(s, 0) * 7
            v = (torch.rand(n, generator=gen, device="cuda") < 0.6).to(torch.int64)
            new = (blocks.segment_start_index(s), blocks.group_rank(keys),
                   blocks.segment_cumsum(v, s))
            old = (segment_start_cummax(s), group_rank_cummax(keys), segment_cumsum_cummax(v, s))
            for name, x, y in zip(names, new, old):
                assert_equal(f"[scan] {name} n={n} density {d}", x, y)
            if d == SCAN_TIMED_DENSITY:
                timed = (s, keys, v, old)
            del new, old
        s, keys, v, old = timed
        fns = {"segment_start_index": (lambda: blocks.segment_start_index(s),
                                       lambda: segment_start_cummax(s), 9 * n),
               "group_rank": (lambda: blocks.group_rank(keys), lambda: group_rank_cummax(keys),
                              16 * n),
               "segment_cumsum": (lambda: blocks.segment_cumsum(v, s),
                                  lambda: segment_cumsum_cummax(v, s), 17 * n)}
        old_reps = 3 if n >= SCAN_BIG else reps
        for name, (fn, fn_old, n_bytes) in fns.items():
            row[name] = {"ms": cuda_ms(fn, reps), "device_only_ms": cuda_ms(fn, reps, queued=True),
                         "cummax_ms": cuda_ms(fn_old, old_reps), **bound(n_bytes)}
        cumsum = lambda: torch.cumsum(s, 0)
        row["cumsum"] = {"ms": cuda_ms(cumsum, reps),
                         "device_only_ms": cuda_ms(cumsum, reps, queued=True), **bound(9 * n)}
        # segment_start_index's parts, device-only: the segment id, the two
        # selects, the scatter (the non-starts all into one spare slot), the
        # gather.
        seg = torch.cumsum(s, 0) - 1
        idx = torch.arange(n, device="cuda")
        at, val = torch.where(s, seg, n), torch.where(s, idx, 0)
        first = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
        parts = {"segment_id": lambda: torch.cumsum(s, 0) - 1,
                 "selects": lambda: (torch.where(s, seg, n), torch.where(s, idx, 0)),
                 "scatter": lambda: first.index_copy_(0, at, val), "gather": lambda: first[seg]}
        row["segment_start_index"]["parts_device_only_ms"] = {
            k: cuda_ms(fn, reps, queued=True) for k, fn in parts.items()}
        del seg, idx, at, val, first, parts
        if n < SCAN_BIG:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = (blocks.segment_start_index(s), blocks.group_rank(keys),
                       blocks.segment_cumsum(v, s))
            graph.replay()
            torch.cuda.synchronize()
            for name, x, y in zip(names, got, old):
                assert_equal(f"[scan] {name} n={n} in a CUDA graph", x, y)
            del graph, got
            for name, (fn, _, _) in fns.items():
                row[name]["graph_ms"] = graph_ms(fn)
        del s, keys, v, old, timed
        torch.cuda.empty_cache()
        rows.append(row)
        graph_note = ", eagerly and in a CUDA graph" if n < SCAN_BIG else ", eagerly"
        print(f"[scan] n={n} ({'; '.join(used_by)}): equal to the cummax forms at start densities "
              f"{list(SCAN_DENSITIES)}{graph_note}; at density {SCAN_TIMED_DENSITY}, ms (events "
              f"around the call; device-only; in a graph) against the cummax form, and the bound: "
              + "; ".join(
                  f"{name} {row[name]['ms']:.4f} ({row[name]['device_only_ms']:.4f}; "
                  f"{row[name].get('graph_ms', float('nan')):.4f}) against "
                  f"{row[name]['cummax_ms']:.4f}, bound {row[name]['bound_ms']:.4f} by "
                  f"{row[name]['bound_by']}" for name in names)
              + f"; torch.cumsum of the starts {row['cumsum']['ms']:.4f} "
              f"({row['cumsum']['device_only_ms']:.4f}), bound {row['cumsum']['bound_ms']:.4f}; "
              f"segment_start_index's parts, device-only: " + ", ".join(
                  f"{part} {t:.4f}"
                  for part, t in row["segment_start_index"]["parts_device_only_ms"].items())
              + f" ({card})")
    return rows


def drive_pair_frames(tag, name, cfg, params, synth, counters, card, patches, frames=10, loop=8,
                      rounds=5, template_path=None):
    """Two maps of one preset fed the same frames, the preset's noise on,
    one a way: ``patches`` maps each of the two ways to a context factory,
    and every frame of that way's map (the eager first, the captured
    second, the replays after) runs inside it.  ``frames`` frames in turns,
    each timed with CUDA events around ``update()`` and on the host's clock
    with a synchronize: state (the generator too), render and counters
    bit-equal every frame, and with ``template_path`` (both maps load that
    bank) the sweep records too.  Then ``rounds`` rounds of loops of
    ``loop`` frames with one synchronize at the end of each, as the bench
    loops run, in turns (first, second, second, first; each pair on the
    same frames), and last one more replayed frame of each under
    torch.profiler (device busy, host API calls, the top 15 ops).  The
    launch counts of ``counters`` are set to 0 before the first frame and
    read after the last.  Returns the numbers, the template branches that
    ran by frame among them; ``tag`` heads the printed lines."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts, SemanticDSPMap

    ways = tuple(patches)
    reset_launches(counters)
    maps = {way: SemanticDSPMap(cfg, params, device="cuda") for way in ways}
    if template_path is not None:
        for dsp in maps.values():
            dsp.set_template_path(str(template_path))
    total = frames + 2 * rounds * loop + 1
    scenes = [synth(cfg, t, MaskKpts) for t in range(total)]

    def frame(way, t):
        with patches[way]():
            return maps[way].update(*scenes[t], 0.1 * t)

    def check(label, out):
        parted = frame_parting(*((maps[w].state, *out[w]) for w in ways))
        if template_path is not None:
            parted += records_differ(*(maps[w]._templates.records for w in ways))
        if parted:
            raise AssertionError(f"[{tag}] {name} {label}: the {ways[1]} map parts from the "
                                 f"{ways[0]} map in {parted}")

    ms = {w: [] for w in ways}
    wall = {w: [] for w in ways}
    branches = {}
    for t in range(frames):
        out = {}
        counts = sweep_counts(maps[ways[0]]) if template_path is not None else None
        for way in ways if t % 2 == 0 else ways[::-1]:
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            w0 = time.perf_counter()
            a.record()
            out[way] = frame(way, t)
            b.record()
            torch.cuda.synchronize()
            wall[way].append((time.perf_counter() - w0) * 1e3)
            ms[way].append(a.elapsed_time(b))
        check(f"frame {t}", out)
        ran = ([sw.stage for sw in sweeps_of_frame(maps[ways[0]], counts)]
               if counts is not None else [])
        if ran:
            branches[t] = ran
        print(f"[{tag}] {name} frame {t}: " + ", ".join(
            f"{w} {ms[w][-1]:.3f} ms (host {wall[w][-1]:.3f})" for w in ways)
            + f"; state, generator, render and counters bit-equal"
            + (f", sweep records too; template branches run: {ran}" if counts is not None else "")
            + f" ({card})")

    loop_ms = {w: [] for w in ways}
    for i, way in enumerate((ways[0], ways[1], ways[1], ways[0]) * rounds):
        first = frames + (i // 2) * loop
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for t in range(first, first + loop):
            out[way] = frame(way, t)
        torch.cuda.synchronize()
        loop_ms[way].append((time.perf_counter() - w0) * 1e3 / loop)
    check(f"after the loops (frame {total - 2})", out)
    t = total - 1
    prof = {}
    for way in ways:
        prof[way] = profile_frame(lambda: out.__setitem__(way, frame(way, t)))
    check(f"profiled frame {t}", out)
    launches = read_launches(counters)
    api = {w: prof[w][0] for w in ways}
    if api[ways[0]] != api[ways[1]]:
        raise AssertionError(f"[{tag}] {name}: host API calls a replayed frame {api}")
    timed = [i for i in range(2, frames) if i not in branches]
    med = {w: float(np.median([ms[w][i] for i in timed])) for w in ways}
    med_wall = {w: float(np.median([wall[w][i] for i in timed])) for w in ways}
    med_loop = {w: float(np.median(loop_ms[w])) for w in ways}
    ops = {w: top_ops(prof[w][1]) for w in ways}
    busy = {w: {"busy_ms": prof[w][2], "wall_ms": prof[w][3], "kernels": prof[w][4]}
            for w in ways}
    print(f"[{tag}] {name}: medians over frames {timed}, in turns (update(), events; host): "
          + ", ".join(f"{w} {med[w]:.3f} ms ({med_wall[w]:.3f})" for w in ways)
          + f"; {2 * rounds} loops each of {loop} frames, one synchronize a loop, ms a frame, "
          f"median (all): " + ", ".join(
              f"{w} {med_loop[w]:.3f} (" + " / ".join(f"{x:.3f}" for x in loop_ms[w]) + ")"
              for w in ways)
          + f"; a replayed frame (profiled frame {t}): " + ", ".join(
              f"{w} device busy {busy[w]['busy_ms']:.3f} of {busy[w]['wall_ms']:.3f} ms, "
              f"{busy[w]['kernels']} kernels, {api[w]} host API calls" for w in ways)
          + f" ({card})")
    for w in ways:
        print(f"[{tag}] {name} {w}: the top {len(ops[w])} ops of the replayed frame by device ms "
              f"(profiler; ms, launches, op): {top_ops_line(ops[w])} ({card})")
    del maps
    return {"ms": ms, "wall_ms": wall, "median_ms": med, "median_wall_ms": med_wall,
            "loop_ms_per_frame": loop_ms, "median_loop_ms": med_loop, "api_calls": api,
            "device_busy": busy, "top_ops": ops, "launches": launches, "frames": total,
            "branches": branches, "by_op": {w: prof[w][1] for w in ways}}


def drive_scan_frames(name, cfg, params, synth, counters, card):
    """[scan]'s frames (``drive_pair_frames``): "new", built as the package
    builds it, and "cummax", whose every frame runs inside
    ``cummax_scans``; the frame kernels run once a frame in each map.
    Returns the numbers, the scans' calls by (function, length) among
    them."""
    import collections

    calls = collections.Counter()
    out = drive_pair_frames("scan", name, cfg, params, synth, counters, card,
                            {"new": contextlib.nullcontext, "cummax": lambda: cummax_scans(calls)})
    if {fn for fn, _ in calls} != {"segment_cumsum", "group_rank"}:
        raise AssertionError(f"[scan] {name}: the cummax map's scans ran as {dict(calls)}")
    hold_runs(f"[scan] {name}", out["launches"], 2 * out["frames"])
    print(f"[scan] {name}: the cummax map's scans by (function, length), calls: "
          f"{sorted(calls.items())}; launches {out['launches']} ({out['frames']} frames each)")
    del out["by_op"], out["branches"]
    return {**out, "scan_calls": sorted(calls)}


def run_scan(counters, card) -> dict:
    """[scan]: the frames of ``drive_scan_frames`` at the VKITTI2 and the
    ZED2 preset and on the hostile scene (the bench's host-bound cell),
    then ``check_scans`` at every length those frames' scans ran at and at
    SCAN_BIG."""
    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, virtual_kitti2_config, zed2_config

    scenes = bench_scenes()
    frames = {}
    for name, cfg, params, synth in (
            ("vkitti2", virtual_kitti2_config(), scenes.VK_PARAMS, scenes.synth_vkitti2_frame),
            ("zed2", zed2_config(), scenes.ZED2_PARAMS, scenes.synth_zed2_frame),
            ("vkitti2_hostile", virtual_kitti2_config(), scenes.VK_PARAMS,
             scenes.synth_hostile_frame)):
        frames[name] = drive_scan_frames(name, cfg, FilterParams(**params), synth, counters, card)
        torch.cuda.empty_cache()
    lengths = {SCAN_BIG: ["V*K at VKITTI2"]}
    for name, out in frames.items():
        for fn, n in out["scan_calls"]:
            lengths.setdefault(n, []).append(f"{name} {fn}")
    return {"frames": frames, "lengths": check_scans(lengths, card)}


# ---------------------------------------------------------------------------
# [merge]: birth's block merge, the kernel against the plain version
# ---------------------------------------------------------------------------

#: The profiler's name of the merge kernel (csrc/birth.cu) holds this.
MERGE_KERNEL = "merge_kernel"


@contextlib.contextmanager
def merge_way(way, calls):
    """[merge]'s context for one way's frames: every module that binds
    ``_insert_core`` (``ops.birth``, ``map``, ``template_engine``,
    ``parallel.shard_step``) holds a wrapper that adds one to
    ``calls[way]`` a call, and for the way "plain" ``ops.birth.merge_blocks``
    is ``merge_blocks_plain``: a step built and captured inside runs the
    plain merge in every replay.  Nothing of the package changes outside
    the block."""
    from semantic_dsp_map_tpu_torch import map as map_module, template_engine
    from semantic_dsp_map_tpu_torch.ops import birth
    from semantic_dsp_map_tpu_torch.parallel import shard_step

    core = birth._insert_core

    def counted(*args, **kwargs):
        calls[way] += 1
        return core(*args, **kwargs)

    patches = [(m, "_insert_core", counted) for m in (birth, map_module, template_engine,
                                                        shard_step)]
    if way == "plain":
        patches.append((birth, "merge_blocks", birth.merge_blocks_plain))
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, fn in patches:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def merge_checks(tag, out, calls, card, template=False):
    """What [merge] holds each path to, from ``drive_pair_frames`` or
    ``drive_sharded_pair``'s numbers: the frame kernels ran once a frame in
    each map; both ways called ``_insert_core`` alike, ``inserts_a_frame``
    times a frame, each call twice in Python (the eager frame, the capture;
    a replay calls nothing); the merge kernel ran once per ``_insert_core``
    of the kernel map's frames, and inside the profiled replay once per
    insert, the plain map's never.  Returns (inserts a frame, the kernel's
    ms in the kernel map's replay, the kernel's runs)."""
    frames = out["frames"]
    per_frame, odd = divmod(calls["kernel"], 2)
    hits = {w: [(ms, n) for op, (ms, n) in out["by_op"][w].items() if MERGE_KERNEL in op]
            for w in ("kernel", "plain")}
    want = {f: frames * runs_a_frame(f, template) * (1 if f == MERGE_FN else 2)
            for f in out["launches"]}
    bad = [] if out["launches"] == want else [f"kernel runs {out['launches']}, want {want}"]
    if odd or per_frame != inserts_a_frame(template) or calls["plain"] != calls["kernel"]:
        bad.append(f"_insert_core calls {dict(calls)}")
    if len(hits["kernel"]) != 1 or hits["kernel"][0][1] != per_frame or hits["plain"]:
        bad.append(f"the merge kernel in the profiled replays {hits}")
    if bad:
        raise AssertionError(f"[merge] {tag} over {frames} frames of each map: {'; '.join(bad)}")
    merges = out["launches"].pop(MERGE_FN)
    in_replay = hits["kernel"][0][0]
    print(f"[merge] {tag}: {per_frame} _insert_core calls a frame in both maps; the merge kernel "
          f"ran {merges} times in {frames} frames of the kernel map (once per _insert_core), "
          f"none in the plain map; inside the profiled replay {per_frame} launches, "
          f"{in_replay:.4f} ms; the frame kernels once a frame in each map ({card})")
    del out["by_op"]
    return per_frame, in_replay, merges


def run_merge(counters, card) -> dict:
    """[merge]: two maps of each path fed the same noise-on frames in
    turns (``drive_pair_frames``): "kernel", built as the package builds
    it (the merge kernel of csrc/birth.cu on every path that inserts), and
    "plain", whose every frame runs inside ``merge_way("plain")``: state,
    generator, render, counters (and sweep records) bit-equal every frame;
    update() medians, loops of 8, one profiled replay each.  Paths:
    vkitti2, zed2, the hostile scene and vkitti2_template (the birth branch
    on frame TPL_LATE_CAR, the rematch branch on TPL_LOST)."""
    import collections

    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, virtual_kitti2_config, zed2_config

    scenes = bench_scenes()
    vk = virtual_kitti2_config()
    out = {}
    for name, cfg, params, synth, tpl in (
            ("vkitti2", vk, scenes.VK_PARAMS, scenes.synth_vkitti2_frame, None),
            ("zed2", zed2_config(), scenes.ZED2_PARAMS, scenes.synth_zed2_frame, None),
            ("vkitti2_hostile", vk, scenes.VK_PARAMS, scenes.synth_hostile_frame, None),
            ("vkitti2_template", vk, scenes.TPL_PARAMS, late_template_frame, TEMPLATES)):
        calls = collections.Counter()
        res = drive_pair_frames(
            "merge", name, cfg, FilterParams(**params), synth, counters, card,
            {w: (lambda w=w: merge_way(w, calls)) for w in ("kernel", "plain")},
            rounds=2, template_path=tpl)
        if tpl is not None and (res["branches"].get(TPL_LATE_CAR) != ["birth"]
                                or res["branches"].get(TPL_LOST) != ["rematch"]):
            raise AssertionError(f"[merge] {name}: template branches ran on {res['branches']}")
        res["inserts_per_frame"], res["kernel_ms_in_replay"], res["merge_runs"] = merge_checks(
            name, res, calls, card, template=tpl is not None)
        out[name] = res
        torch.cuda.empty_cache()
    return out


def drive_sharded_merge(counters, card, frames=4):
    """[merge] on the sharded step at one rank (``drive_sharded_pair``):
    one captured step built as the package builds it, one whose every call
    runs inside ``merge_way("plain")``."""
    import collections

    calls = collections.Counter()
    out = drive_sharded_pair("merge", counters, card,
                             {w: (lambda w=w: merge_way(w, calls)) for w in ("kernel", "plain")},
                             frames)
    out["inserts_per_frame"], out["kernel_ms_in_replay"], out["merge_runs"] = merge_checks(
        "sharded vkitti2", out, calls, card)
    return out


# ---------------------------------------------------------------------------
# [visible]: the PHD update over a VisibleSet, and insert_particles
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` is ``value`` inside the block."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def store_copy(p):
    """A copy of a particle store (the functions [visible] runs work in place)."""
    import dataclasses

    return type(p)(**{f.name: getattr(p, f.name).clone() for f in dataclasses.fields(p)})


def assert_same_store(tag, a, b):
    """Every field of two stores equal, floats by their bits."""
    import dataclasses

    import torch

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert_equal(f"{tag} {f.name}", x, y)


def visible_set_of_store(cfg, p, r_cw, t_cw, pad=4096, seed=0):
    """The VisibleSet of every live slot of the store ``p`` whose position
    projects into the image within the depth range (``project_to_image``):
    each entry's voxel and slot, pixel, position, weight, track and forget
    count; about a tenth marked invisible (seeded), and ``pad`` padding
    entries past the real ones.  Returns (set, real entries)."""
    import torch
    from semantic_dsp_map_tpu_torch.ops.geometry import project_to_image
    from semantic_dsp_map_tpu_torch.ops.projection import VisibleSet
    from semantic_dsp_map_tpu_torch.state import STATUS_INVALID

    K = cfg.slots_per_voxel
    idx = torch.nonzero(p.status != STATUS_INVALID).squeeze(1)
    pos = torch.stack([p.px[idx], p.py[idx], p.pz[idx]], dim=-1)
    row, col, _, ok = project_to_image(cfg, r_cw, t_cw, pos)
    idx, row, col, pos = idx[ok], row[ok], col[ok], pos[ok]
    n = idx.numel()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    visible = torch.rand(n, generator=gen, device="cuda") >= 0.1

    def padded(x, fill):
        return torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)])

    i32 = torch.int32
    vis = VisibleSet(
        vox=padded((idx // K).to(i32), -1), slot=padded((idx % K).to(i32), 0),
        row=padded(row, 0), col=padded(col, 0), pos=padded(pos, 0.0),
        weight=padded(p.weight[idx], 0.0), track=padded(p.track[idx].to(i32), -1),
        forget=padded(p.forget[idx].to(i32), 0), visible=padded(visible, False),
        count=visible.sum().to(i32))
    return vis, n


def visible_phd(cfg, params, dsp, vis, cloud, card):
    """[visible] (a): ``compute_ck_kappa`` and ``phd_weight_update`` over
    ``vis`` with the CUDA passes, then with the plain stencils on the card
    (``use_pallas_phd`` off), each update on a copy of the map's store:
    ck_kappa and the new weights within the tolerance, status and stamp and
    every other field equal, forget counts equal away from the 0.1
    threshold of the "rightly updated" flag (``window_census``).  The
    passes' launches are counted over the two kernel calls alone.  Then
    each pass alone on this table, timed, beside its bound.  Returns the
    numbers."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch.ops import phd, phd_cuda

    plain_cfg = dataclasses.replace(cfg, use_pallas_phd=False)
    gt = dsp.state.global_time + 1  # frame 3's time: every slot written gets a new stamp
    p_k, p_p = store_copy(dsp.state.particles), store_copy(dsp.state.particles)
    passes = (phd_cuda.pass_a_cuda, phd_cuda.pass_b_cuda)
    reset_launches(passes)
    ck_k = phd.compute_ck_kappa(cfg, params, vis, cloud)
    phd.phd_weight_update(cfg, params, vis, cloud, p_k, gt)
    torch.cuda.synchronize()
    launches = read_launches(passes)
    if launches != {"pass_a_cuda": 2, "pass_b_cuda": 1}:
        raise AssertionError(f"[visible] launches of the PHD passes {launches}, want A 2, B 1")
    ck_p = phd.compute_ck_kappa(plain_cfg, params, vis, cloud)
    phd.phd_weight_update(plain_cfg, params, vis, cloud, p_p, gt)
    torch.cuda.synchronize()
    if read_launches(passes) != launches:
        raise AssertionError("[visible] the plain update launched a PHD kernel")
    assert_close("[visible] ck_kappa", ck_k, ck_p)
    assert_close("[visible] weight", p_k.weight, p_p.weight)
    for name in ("status", "stamp", "px", "py", "pz", "label", "track"):
        assert_equal(f"[visible] {name}", getattr(p_k, name), getattr(p_p, name))

    t = phd.build_pixel_table(cfg, vis)
    S, H, W = t.px.shape
    occupied = t.meta >= 0
    ff = phd.forgetting_factor(t.meta & 0xFF, params.forgetting_rate, params.max_forget_count)
    weff = torch.where(occupied, t.weight if params.if_use_independent_filter else t.weight * ff,
                       0.0)
    a_args = pass_a_inputs(cfg, params, t, cloud, weff)
    b_args = pass_b_inputs(cfg, params, t, cloud, ck_k)
    # forget counts may part only where the flag's pdf lies within 1e-6 of
    # its threshold (the flag does not read ck_kappa)
    near, _ = window_census(b_args)
    key, rank, keep = phd._pixel_entries(cfg, vis)
    dest = torch.where(keep, rank.long() * (H * W) + key, 0)
    slot = vis.vox.long() * cfg.slots_per_voxel + vis.slot.long()
    allowed = torch.zeros_like(p_k.forget, dtype=torch.bool)
    allowed[slot[keep]] = near.reshape(-1)[dest[keep]]
    differ = p_k.forget != p_p.forget
    if bool((differ & ~allowed).any()):
        raise AssertionError(f"[visible] {int((differ & ~allowed).sum())} forget counts differ "
                             "away from the threshold")
    n_near = int(near.sum())

    ck_raw = phd_cuda.pass_a_cuda(*a_args)
    acc, right = phd_cuda.pass_b_cuda(*b_args)
    census = pass_a_census(a_args)
    bound_a, _, _ = pass_a_bound(a_args, ck_raw, census)
    bound_b, _, terms_b = pass_b_bound(b_args, acc, right)
    run_a, run_b = lambda: phd_cuda.pass_a_cuda(*a_args), lambda: phd_cuda.pass_b_cuda(*b_args)
    ms_a, q_a = cuda_ms(run_a, 10), cuda_ms(run_a, 10, queued=True)
    ms_b, q_b = cuda_ms(run_b, 10), cuda_ms(run_b, 10, queued=True)
    plain_a = cuda_ms(lambda: phd.pass_a_raw(*a_args), 3)
    plain_b = cuda_ms(lambda: phd.pass_b_raw(*b_args), 3)
    P, n_real = vis.vox.shape[0], int((vis.vox >= 0).sum())
    n_vis, dropped = int(vis.count), int(t.dropped)
    out = {"P": P, "real": n_real, "visible": n_vis, "dropped_rank_ge_S": dropped,
           "table_entries": int(occupied.sum()), "forget_differing": int(differ.sum()),
           "near_threshold": n_near, "launches": launches,
           "ck_max_abs_err": max_err(ck_k, ck_p)[0],
           "weight_max_abs_err": max_err(p_k.weight, p_p.weight)[0],
           "updated_slots": int((p_k.stamp != dsp.state.particles.stamp).sum()),
           "pass_a": {"ms": ms_a, "queued_ms": q_a, "plain_ms": plain_a, **census, **bound_a},
           "pass_b": {"ms": ms_b, "queued_ms": q_b, "plain_ms": plain_b, "terms": terms_b,
                      **bound_b}}
    print(f"[visible] VisibleSet of the store's live slots in view: P={P} ({n_real} real, "
          f"{n_vis} visible, {P - n_real} padding), {dropped} dropped at rank >= S={S}, "
          f"{out['table_entries']} table entries; {out['updated_slots']} slots updated")
    print(f"[visible] compute_ck_kappa + phd_weight_update, kernels against the plain stencils "
          f"on the card: ck_kappa max abs {out['ck_max_abs_err']:.3e}, weight max abs "
          f"{out['weight_max_abs_err']:.3e} (rtol {RTOL} / atol {ATOL}); status, stamp and the "
          f"rest equal; forget differing {out['forget_differing']} (entries near the threshold "
          f"{n_near}); launches {launches} ({card})")
    print(f"[visible] pass A {ms_a:.4f} ms ({q_a:.4f} device-only), plain {plain_a:.3f} ms, "
          f"bound {bound_a['bound_ms']:.4f} ms by {bound_a['bound_by']}; pass B {ms_b:.4f} ms "
          f"({q_b:.4f} device-only), plain {plain_b:.3f} ms, bound {bound_b['bound_ms']:.4f} ms "
          f"by {bound_b['bound_by']} ({card})")
    return out


def visible_insert(cfg, params, dsp, cloud, card, reps=10):
    """[visible] (b): ``insert_particles`` of frame 3's newborn candidates on
    three copies of the map's store: on the card (the merge kernel's
    acceptance instance, its launch counted over this call alone), with
    ``merge_blocks_plain`` patched into ``ops.birth`` on the card, and
    ``_insert_core`` alone (the count-only instance): the stores equal bit
    for bit, ``accepted`` and the voxels equal, ``accepted.sum()`` the
    count-only launch's count.  Then both instances on the recorded merge
    arguments, each launch from the store as it was, in turns (acceptance,
    count-only, count-only, acceptance), beside the plain version and the
    bound (``merge_bound`` plus the mask's bytes).  Returns the numbers."""
    import torch
    from semantic_dsp_map_tpu_torch.ops import birth
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import (
        merge_blocks_accepted_cuda, merge_blocks_cuda,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    gt = dsp.state.global_time + 1
    cand = birth.newborn_candidates(cfg, params, cloud, gt, gen)
    scroll, base = dsp.state.scroll, dsp.state.particles
    p_k, p_p, p_c = store_copy(base), store_copy(base), store_copy(base)
    wrappers = (merge_blocks_accepted_cuda, merge_blocks_cuda)
    reset_launches(wrappers)
    with CallRecorder(birth, "merge_blocks") as rec:
        _, acc_k, vox_k = birth.insert_particles(cfg, p_k, scroll, cand)
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    if launches != {"merge_blocks_accepted_cuda": 1, "merge_blocks_cuda": 0}:
        raise AssertionError(f"[visible] insert_particles launched {launches}")
    with patched(birth, "merge_blocks", birth.merge_blocks_plain):
        _, acc_p, vox_p = birth.insert_particles(cfg, p_p, scroll, cand)
    res_c = birth._insert_core(cfg, p_c, scroll, cand, resample_targets=False)
    torch.cuda.synchronize()
    assert_same_store("[visible] insert_particles store, kernel", p_k, p_p)
    assert_same_store("[visible] insert_particles store, count-only", p_c, p_p)
    assert_equal("[visible] accepted", acc_k, acc_p)
    assert_equal("[visible] voxel", vox_k, vox_p)
    n_acc = int(acc_k.sum())
    if n_acc != int(res_c.accepted_count) or n_acc == 0:
        raise AssertionError(f"[visible] {n_acc} accepted, the count-only launch counted "
                             f"{int(res_c.accepted_count)}")

    cfg_m, flat, blocks, vax, staged, resample = rec.calls[0]
    keep = store_copy(flat)
    _, _, mask_p = birth.merge_blocks_plain(cfg_m, flat, blocks, vax, staged, resample,
                                            want_accepted=True)
    work = store_copy(keep)

    def restore():
        for name in keep.__dataclass_fields__:
            getattr(work, name).copy_(getattr(keep, name))

    acc_run = lambda: merge_blocks_accepted_cuda(cfg_m, work, blocks, vax, staged, resample)
    cnt_run = lambda: merge_blocks_cuda(cfg_m, work, blocks, vax, staged, resample)
    _, _, mask_k = acc_run()
    torch.cuda.synchronize()
    assert_equal("[visible] the acceptance instance's mask", mask_k, mask_p)
    assert_same_store("[visible] the acceptance instance's store", work, flat)
    both = lambda f: (cuda_ms(f, reps, setup=restore), cuda_ms(f, reps, queued=True, setup=restore))
    turns = {"accepted": [both(acc_run)], "count_only": [both(cnt_run)]}
    turns["count_only"].append(both(cnt_run))
    turns["accepted"].append(both(acc_run))
    plain_ms = cuda_ms(lambda: birth.merge_blocks_plain(cfg_m, work, blocks, vax, staged, resample,
                                                        want_accepted=True), 3, setup=restore)
    b, n_real = merge_bound(cfg_m, blocks, staged, {k: getattr(keep, k) for k in
                                                    keep.__dataclass_fields__},
                            flat, resample, n_acc)
    b_count = b["bound_ms"]
    b = bound(b["bound_ms"] * 1e-3 * HBM_BYTES_PER_S + mask_p.numel())
    ms = float(np.median([t[0] for t in turns["accepted"]]))
    q_ms = float(np.median([t[1] for t in turns["accepted"]]))
    out = {"candidates": cand.pos.shape[0], "accepted": n_acc, "rows": blocks.ids.shape[0],
           "real_rows": n_real, "launches": launches, "turns_ms": turns, "ms": ms,
           "device_only_ms": q_ms, "plain_ms": plain_ms, "max_abs_err": 0.0,
           "count_only_bound_ms": b_count, **b}
    f = lambda t: f"{t[0]:.4f} ({t[1]:.4f})"
    print(f"[visible] insert_particles: {out['candidates']} newborn candidates of frame 3, "
          f"{n_acc} accepted into {n_real} of {out['rows']} rows; the acceptance instance's "
          f"store and mask equal to merge_blocks_plain's, its sum the count-only launch's count; "
          f"launches {launches} ({card})")
    print(f"[visible] merge in turns, ms (device-only): acceptance {f(turns['accepted'][0])}, "
          f"count-only {f(turns['count_only'][0])}, count-only {f(turns['count_only'][1])}, "
          f"acceptance {f(turns['accepted'][1])}; plain {plain_ms:.3f} ms; bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']} (count-only {b_count:.4f}) ({card})")
    return out


def run_visible(card) -> dict:
    """[visible]: a VKITTI2 map at full width (the default preset: 1242 x
    375, S = 12, R = 5, 8,388,608 voxels, K = 7) driven three frames of
    ``synth_vkitti2_frame``; then, on frame 3's cloud, the PHD update over
    the VisibleSet of the store's live slots in view (``visible_phd``) and
    ``insert_particles`` of the frame's newborn candidates
    (``visible_insert``)."""
    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, SemanticDSPMap
    from semantic_dsp_map_tpu_torch import virtual_kitti2_config
    from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices

    scenes = bench_scenes()
    cfg, params = virtual_kitti2_config(), FilterParams(**scenes.VK_PARAMS)
    synth = scenes.synth_vkitti2_frame
    dsp = SemanticDSPMap(cfg, params, device="cuda")
    for t in range(3):
        dsp.update(*synth(cfg, t, MaskKpts), 0.1 * t)
    _, f, cloud = frame_cloud(dsp, synth, 3)
    _, _, r_cw, t_cw = camera_matrices(f.cam_pos, f.cam_quat)
    vis, _ = visible_set_of_store(cfg, dsp.state.particles, r_cw, t_cw)
    out = {"phd": visible_phd(cfg, params, dsp, vis, cloud, card)}
    del vis
    torch.cuda.empty_cache()
    out["insert"] = visible_insert(cfg, params, dsp, cloud, card)
    del dsp
    torch.cuda.empty_cache()
    return out


def drive_rematch(counters, card, lost=5, frames=7):
    """The VKITTI2 scene with the car's keypoints withheld on frame ``lost``,
    after the car has moved for three frames and has a velocity: the object
    layer's keypoint fit cannot run, the coast branch sets the car's
    transform to its velocity over the default interval, and the rigid move
    goes on.  Returns (launches, that frame's quantities)."""
    import dataclasses

    import torch
    from semantic_dsp_map_tpu_torch import (
        FilterParams, MaskKpts, SemanticDSPMap, virtual_kitti2_config,
    )
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
    hold_runs("rematch", launches, frames)
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


def frame_parting(a, b):
    """Names of what two frames (state, render, counters) do not hold bit
    for bit, the state's generator included."""
    import torch

    (sa, ra, da), (sb, rb, db) = a, b
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    out = states_differ(sa, sb)
    out += [f"render.{f}" for f in ra._fields
            if not torch.equal(bits(getattr(ra, f)), bits(getattr(rb, f)))]
    if {k: int(v) for k, v in da._asdict().items()} != {k: int(v) for k, v in db._asdict().items()}:
        out.append("diagnostics")
    return out


def sharded_parting(a, b, gen_a, gen_b):
    """``frame_parting`` of two sharded frames, each way's rank generator
    ``gen_*`` included."""
    out = frame_parting(a, b)
    if not gen_a.get_state().equal(gen_b.get_state()):
        out.append("rank_rng")
    return out


#: The ways [sharded] runs the VKITTI2 frame in turns: the single-device
#: eager step, the eager sharded step (the oracle), the captured sharded
#: step on the FrameInput and on the packed buffer.
SHARDED_WAYS = ("plain", "eager", "captured", "captured_packed")


def sharded_inputs(cfg, registry, t):
    """Frame t of the VKITTI2 scene on the card, as a FrameInput and as the
    packed buffer."""
    import torch
    from semantic_dsp_map_tpu_torch import MaskKpts
    from semantic_dsp_map_tpu_torch.frontend import FrameInput, build_frame_input, pack_frame

    raw = (*bench_scenes().synth_vkitti2_frame(cfg, t, MaskKpts), 0.1 * t)
    f = FrameInput(*(torch.as_tensor(np.asarray(a)).to("cuda")
                     for a in build_frame_input(cfg, registry, *raw)))
    return f, torch.from_numpy(pack_frame(cfg, registry, *raw)).to("cuda")


def drive_sharded_vkitti2(counters, card, frames=8, noise_frames=6):
    """The sharded step (parallel/shard_step.py) at one rank of the default
    group, on the VKITTI2 preset at full width with the movers in
    (prediction_stddev=0.0), four ways taken each frame in turns (the order
    rotates frame by frame), each timed with CUDA events: the single-device
    step (``build_frame_step``), the eager sharded step
    (``build_shard_step_eager``, the oracle), and the captured sharded step
    (``build_shard_step``: frame 0 eager, frame 1 captured, replays after;
    graphs "fit" and "finish" around the refit's eager SVD) unpacked and
    packed.  After every frame both captured ways must equal the oracle bit
    for bit (every state tensor, the state's and the rank's generators, the
    render, the counters), and the oracle the single-device step (integer
    tensors, voxel stamps and the nine counters bit for bit, floats within
    1e-6; occ, label and track bit for bit, weight_sum within 1e-6).  Each
    sharded call runs with the launch counts set to 0 just before it and
    read just after (``step_graph.kernel_runs``): the five kernels of the
    path must run once a call, birth's merge once per ``_insert_core``
    (``hold_runs``).  The bridge is timed in the captured frames
    (host ms, device ms between events); one more frame of each sharded way
    runs under torch.profiler (host API calls by name, device busy share).
    Then ``noise_frames`` frames with the preset's noise on (depth noise,
    move jitter): the captured ways against the oracle, bit for bit, which
    shows that replays draw from both generators.  Returns the numbers."""
    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, virtual_kitti2_config
    from semantic_dsp_map_tpu_torch.labels import LabelRegistry
    from semantic_dsp_map_tpu_torch.map import build_frame_step
    from semantic_dsp_map_tpu_torch.parallel.shard_step import (
        build_shard_step, build_shard_step_eager,
    )
    from semantic_dsp_map_tpu_torch.parallel.sharding import gather_render, shard_state
    from semantic_dsp_map_tpu_torch.state import init_map_state

    scenes = bench_scenes()
    cfg = virtual_kitti2_config()
    registry = LabelRegistry.default()
    dev = torch.device("cuda")
    sharded = SHARDED_WAYS[1:]

    def build(params, ways):
        steps = {"plain": build_frame_step(cfg, params, registry),
                 "eager": build_shard_step_eager(cfg, params, registry),
                 "captured": build_shard_step(cfg, params, registry),
                 "captured_packed": build_shard_step(cfg, params, registry, packed=True)}
        states = {w: init_map_state(cfg, 0, dev) if w == "plain"
                  else shard_state(cfg, init_map_state(cfg, 0, dev), 0, 1) for w in ways}
        return {w: steps[w] for w in ways}, states

    def inputs_of(t):
        f, packed = sharded_inputs(cfg, registry, t)
        return {"plain": f, "eager": f, "captured": f, "captured_packed": packed}

    def check_captured(tag, t, steps, out):
        for way in ("captured", "captured_packed"):
            parted = sharded_parting(out[way], out["eager"], steps[way].stages.rank_rng.gen,
                                     steps["eager"].stages.rank_rng.gen)
            if parted:
                raise AssertionError(f"[sharded] {tag} frame {t}: {way} parts from the eager "
                                     f"sharded step in {parted}")
            kind = "packed" if way == "captured_packed" else "frame"
            graphs = steps[way].static.graphs
            want = set() if t == 0 else {(kind, "fit"), (kind, "finish")}
            if set(graphs) != want or (t and any(graphs[kind, "fit"].launches.values())):
                raise AssertionError(f"[sharded] {tag} frame {t}: {way} graphs {list(graphs)}")

    print(f"[sharded] vkitti2: grid {cfg.num_voxels} voxels x K={cfg.slots_per_voxel}, image "
          f"{cfg.width}x{cfg.height}, R={cfg.neighbor_half}: the table slab is "
          f"[{cfg.phd_pixel_table_slots}, {cfg.height + 2 * cfg.neighbor_half}, {cfg.width}]")
    steps, states = build(FilterParams(**dict(scenes.VK_PARAMS, prediction_stddev=0.0)),
                          SHARDED_WAYS)
    bridge = {"host_ms": [], "events": []}
    static_bridge = None

    def timed_bridge(fit):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        w0 = time.perf_counter()
        static_bridge(fit)
        bridge["host_ms"].append((time.perf_counter() - w0) * 1e3)
        b.record()
        bridge["events"].append((a, b))

    ms = {w: [] for w in SHARDED_WAYS}
    wall = {w: [] for w in SHARDED_WAYS}
    work = {w: [] for w in SHARDED_WAYS}
    launches = dict.fromkeys((fn.__name__ for fn in counters), 0)
    worst, bits, moved = 0.0, True, []
    for t in range(frames):
        if t == 1:
            static_bridge = steps["captured"].static._bridge
            steps["captured"].static._bridge = timed_bridge
        inputs = inputs_of(t)
        out = {}
        for way in SHARDED_WAYS[t % 4 :] + SHARDED_WAYS[: t % 4]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            if way != "plain":
                reset_launches(counters)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            w0 = time.perf_counter()
            a.record()
            out[way] = steps[way](states[way], inputs[way])
            b.record()
            torch.cuda.synchronize()
            wall[way].append((time.perf_counter() - w0) * 1e3)
            ms[way].append(a.elapsed_time(b))
            work[way].append(torch.cuda.max_memory_allocated() - resident)
            if way != "plain":
                runs = read_launches(counters)
                hold_runs(f"[sharded] vkitti2 frame {t} {way}", runs, 1)
                for fname, n in runs.items():
                    launches[fname] += n
            states[way] = out[way][0]
        check_captured("vkitti2", t, steps, out)
        _, r1, d1 = out["plain"]
        want = {k: int(v) for k, v in d1._asdict().items()}
        moved.append(want["moved_count"])
        _, r, d = out["eager"]
        got = {k: int(v) for k, v in d._asdict().items()}
        if got != want:
            raise AssertionError(f"sharded vkitti2 frame {t}: counters {got}, single-device {want}")
        r = gather_render(r)
        for field in ("occ", "label", "track"):
            assert_equal(f"sharded vkitti2 frame {t} {field}", getattr(r, field), getattr(r1, field))
        err, differ, same = state_parting(states["eager"], states["plain"])
        err = max(err, max_err(r.weight_sum, r1.weight_sum)[0])
        if differ or err > 1e-6:
            raise AssertionError(f"sharded vkitti2 frame {t}: integer tensors {differ} differ, "
                                 f"floats up to {err}")
        worst, bits = max(worst, err), bits and same and torch.equal(r.weight_sum, r1.weight_sum)
        print(f"[sharded] vkitti2 frame {t}: " + ", ".join(
            f"{w} {ms[w][-1]:.3f} ms (host {wall[w][-1]:.3f})" for w in SHARDED_WAYS)
            + f"; the captured ways bit-equal to the eager sharded step, which equals the "
            f"single-device step; counters {want}"
            + (f"; bridge host {bridge['host_ms'][-1]:.3f} ms, device "
               f"{bridge['events'][-1][0].elapsed_time(bridge['events'][-1][1]):.3f} ms"
               if t >= 1 else "") + f" ({card})")
    if not any(moved):
        raise AssertionError("sharded vkitti2: the rigid-move route moved no particle")
    steps["captured"].static._bridge = static_bridge

    # One more frame of each sharded way under the profiler.
    t = frames
    inputs = inputs_of(t)
    prof, out = {}, {}
    for way in sharded:
        prof[way] = profile_frame(lambda: out.__setitem__(way, steps[way](states[way],
                                                                           inputs[way])))
        states[way] = out[way][0]
    check_captured("vkitti2 profiled", t, steps, out)
    timed = list(range(2, frames))
    med = {w: float(np.median([ms[w][i] for i in timed])) for w in SHARDED_WAYS}
    med_wall = {w: float(np.median([wall[w][i] for i in timed])) for w in SHARDED_WAYS}
    device_b = [a.elapsed_time(b) for a, b in bridge["events"]]
    bridge_ms = {"host_ms": bridge["host_ms"], "device_ms": device_b,
                 "median_host_ms": float(np.median(bridge["host_ms"][1:])),
                 "median_device_ms": float(np.median(device_b[1:]))}
    memory = {"capture": work["captured"][1], "capture_packed": work["captured_packed"][1],
              "replay": max(work["captured"][2:]), "eager": max(work["eager"]),
              "reserved": torch.cuda.memory_reserved()}
    api = {w: prof[w][0] for w in sharded}
    busy = {w: {"busy_ms": prof[w][2], "wall_ms": prof[w][3], "kernels": prof[w][4]}
            for w in sharded}
    print(f"[sharded] vkitti2 per-frame medians over frames {timed}, in turns (events; host): "
          + ", ".join(f"{w} {med[w]:.3f} ms ({med_wall[w]:.3f})" for w in SHARDED_WAYS)
          + f"; captured against eager sharded {med['eager'] / med['captured']:.2f}x, against the "
          f"single-device eager step {med['plain'] / med['captured']:.2f}x; the eager sharded step "
          f"equals the single-device one bit for bit: {bits} (floats within {worst:.3e}); moved "
          f"per frame {moved}; kernel runs {launches} ({card})")
    print(f"[sharded] vkitti2 host API calls a frame (profiled frame {t}): "
          + ", ".join(f"{w} {api[w]}" for w in sharded)
          + f"; by name, captured: {prof['captured'][5]}; eager, the first ten: "
          f"{dict(list(prof['eager'][5].items())[:10])}")
    print(f"[sharded] vkitti2 device busy (profiled frame {t}): " + ", ".join(
        f"{w} {busy[w]['busy_ms']:.3f} of {busy[w]['wall_ms']:.3f} ms "
        f"({100 * busy[w]['busy_ms'] / busy[w]['wall_ms']:.1f}%, {busy[w]['kernels']} kernels)"
        for w in sharded) + f" ({card})")
    ops_c = top_ops(prof["captured"][1])
    print(f"[sharded] vkitti2 the top {len(ops_c)} ops of the captured way's profiled frame {t} "
          f"by device ms (profiler; ms, launches, op): {top_ops_line(ops_c)} ({card})")
    print(f"[sharded] vkitti2 the bridge (the eager SVD between the graphs), medians over frames "
          f"2-{frames - 1}: host {bridge_ms['median_host_ms']:.3f} ms, device "
          f"{bridge_ms['median_device_ms']:.3f} ms ({card})")
    print(f"[sharded] vkitti2 memory a frame takes beyond the resident states: capture "
          f"{memory['capture']} bytes (packed {memory['capture_packed']}), replay "
          f"{memory['replay']} bytes, eager sharded {memory['eager']} bytes; reserved after "
          f"{memory['reserved']} bytes")
    del steps, states, out, inputs
    torch.cuda.empty_cache()

    # The noise on: both generators draw, the captured ways against the oracle.
    noisy = FilterParams(**scenes.VK_PARAMS)
    steps, states = build(noisy, sharded)
    noise_ms = {w: [] for w in sharded}
    noise_moved = []
    for t in range(noise_frames):
        inputs = inputs_of(t)
        out = {}
        for way in sharded[t % 3 :] + sharded[: t % 3]:
            reset_launches(counters)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out[way] = steps[way](states[way], inputs[way])
            b.record()
            torch.cuda.synchronize()
            noise_ms[way].append(a.elapsed_time(b))
            runs = read_launches(counters)
            hold_runs(f"[sharded] vkitti2 noise frame {t} {way}", runs, 1)
            for fname, n in runs.items():
                launches[fname] += n
            states[way] = out[way][0]
        check_captured("vkitti2 noise", t, steps, out)
        noise_moved.append(int(out["eager"][2].moved_count))
        print(f"[sharded] vkitti2 noise on (prediction_stddev {noisy.prediction_stddev}, depth "
              f"noise) frame {t}: " + ", ".join(f"{w} {noise_ms[w][-1]:.3f} ms" for w in sharded)
              + f"; the captured ways bit-equal to the eager sharded step, both generators "
              f"included; moved {noise_moved[-1]} ({card})")
    if not any(noise_moved):
        raise AssertionError("sharded vkitti2 noise: the rigid move (the jitter's draws) moved nothing")
    del steps, states, out, inputs
    torch.cuda.empty_cache()
    return {"frames": frames, "ms_median": med, "wall_ms_median": med_wall, "ms": ms,
            "wall_ms": wall, "bit_equal_to_single_device": bits, "max_float_err": worst,
            "moved_count": moved, "launches": launches, "api_calls": api,
            "api_calls_by_name": {w: prof[w][5] for w in sharded}, "device_busy": busy,
            "top_ops_captured": ops_c,
            "bridge": bridge_ms, "memory_bytes": memory, "noise_frames": noise_frames,
            "noise_ms": noise_ms, "noise_moved": noise_moved}


def drive_sharded_pair(tag, counters, card, patches, frames=4):
    """Two captured sharded steps (``build_shard_step``) at one rank, at the
    VKITTI2 preset with its noise on, one a way: ``patches`` maps each of
    the two ways to a context factory, and every call of that way's step
    (the eager first frame, the capture, the replays) runs inside it;
    ``frames`` frames in turns, bit-equal every frame (state, both
    generators, render, counters), then one more frame of each under
    torch.profiler: device busy, host API calls and the top 15 ops of the
    replayed frame.  The launch counts of ``counters`` are set to 0 before
    the first frame and read after the last.  Returns the numbers."""
    import torch
    from semantic_dsp_map_tpu_torch import FilterParams, virtual_kitti2_config
    from semantic_dsp_map_tpu_torch.labels import LabelRegistry
    from semantic_dsp_map_tpu_torch.parallel.shard_step import build_shard_step
    from semantic_dsp_map_tpu_torch.parallel.sharding import shard_state
    from semantic_dsp_map_tpu_torch.state import init_map_state

    ways = tuple(patches)
    cfg, registry = virtual_kitti2_config(), LabelRegistry.default()
    params = FilterParams(**bench_scenes().VK_PARAMS)
    steps = {w: build_shard_step(cfg, params, registry) for w in ways}
    states = {w: shard_state(cfg, init_map_state(cfg, 0, "cuda"), 0, 1) for w in ways}
    reset_launches(counters)
    prof = {}
    for t in range(frames + 1):
        f = sharded_inputs(cfg, registry, t)[0]
        out = {}
        for way in ways if t % 2 == 0 else ways[::-1]:
            def run(way=way):
                with patches[way]():
                    out[way] = steps[way](states[way], f)
                torch.cuda.synchronize()
            if t == frames:
                prof[way] = profile_frame(run)
            else:
                run()
            states[way] = out[way][0]
        parted = sharded_parting(out[ways[0]], out[ways[1]], steps[ways[0]].stages.rank_rng.gen,
                                 steps[ways[1]].stages.rank_rng.gen)
        if parted:
            raise AssertionError(f"[{tag}] sharded vkitti2 frame {t}: the {ways[1]} step parts "
                                 f"from the {ways[0]} step in {parted}")
    launches = read_launches(counters)
    ops = {w: top_ops(prof[w][1]) for w in ways}
    busy = {w: {"busy_ms": prof[w][2], "wall_ms": prof[w][3], "kernels": prof[w][4]}
            for w in ways}
    api = {w: prof[w][0] for w in ways}
    print(f"[{tag}] sharded vkitti2 at one rank, noise on: {frames + 1} frames of both captured "
          f"steps bit-equal (state, both generators, render, counters); the replayed frame "
          f"{frames}: " + ", ".join(
              f"{w} device busy {busy[w]['busy_ms']:.3f} of {busy[w]['wall_ms']:.3f} ms, "
              f"{busy[w]['kernels']} kernels, {api[w]} host API calls" for w in ways)
          + f"; launches {launches} ({card})")
    for w in ways:
        print(f"[{tag}] sharded vkitti2 {w}: the top {len(ops[w])} ops of the replayed frame by "
              f"device ms (profiler; ms, launches, op): {top_ops_line(ops[w])} ({card})")
    del steps, states, out
    torch.cuda.empty_cache()
    return {"frames": frames + 1, "device_busy": busy, "api_calls": api, "top_ops": ops,
            "launches": launches, "by_op": {w: prof[w][1] for w in ways}}


def drive_sharded_scan(counters, card, frames=4):
    """[scan] on the sharded step at one rank (``drive_sharded_pair``): one
    step built as the package builds it, one whose every call runs inside
    ``cummax_scans``."""
    import collections

    calls = collections.Counter()
    out = drive_sharded_pair("scan", counters, card, {"new": contextlib.nullcontext,
                                                      "cummax": lambda: cummax_scans(calls)},
                             frames)
    hold_runs("[scan] sharded vkitti2", out["launches"], 2 * out["frames"])
    if "group_rank" not in {fn for fn, _ in calls}:
        raise AssertionError(f"[scan] sharded vkitti2: the cummax step's scans {dict(calls)}")
    print(f"[scan] sharded vkitti2: the cummax step's scans {sorted(calls.items())}")
    del out["by_op"]
    return {**out, "scan_calls": sorted(calls)}


def check_sharded_zed2(counters, card):
    """``benchmarks.bench.run_sharded_check()`` on the card: the ZED2 preset's
    static scene, 8 frames through the single-device and the sharded step in
    turns (it raises if a render parts), then a warm-up and 8 timed sharded
    frames.  The sharded step (bbox3d: one graph, "step") must replay its
    graph from its second frame on, and the five kernels of the path must
    run once a sharded frame; birth's merge runs once per ``_insert_core``
    of every frame of the check."""
    from semantic_dsp_map_tpu_torch import step_graph
    from semantic_dsp_map_tpu_torch.benchmarks import bench

    reset_launches(counters)
    cell = bench.run_sharded_check()
    total = read_launches(counters)
    replayed = dict(step_graph.replayed)
    n = 2 * cell["frames"] + 1
    # each frame of the check, single-device or sharded, runs pass A once
    if total[MERGE_FN] != inserts_a_frame() * total["pass_a_cuda"]:
        raise AssertionError(f"sharded zed2: kernel runs {total}")
    cell["merge_runs"] = total[MERGE_FN]
    for fname in cell["kernel_launches"]:
        if cell["kernel_launches"][fname] != n or replayed.get(fname) != n - 1:
            raise AssertionError(f"sharded zed2: {fname} ran {cell['kernel_launches'][fname]} "
                                 f"times in {n} sharded frames, {replayed.get(fname)} in replays")
    if cell["graphs"] != [["frame", "step"]]:
        raise AssertionError(f"sharded zed2: graphs {cell['graphs']}, want one, 'step'")
    print(f"[sharded] zed2 ({cell['config']}): render equal to the single-device step on "
          f"{cell['frames']} frames; {1e3 * cell['sec_per_frame']:.3f} ms/frame over {cell['frames']} "
          f"timed frames (host clock, one synchronize); graph {cell['graphs']} replayed on "
          f"{n - 1} of {n} sharded frames; sharded kernel runs {cell['kernel_launches']}, all "
          f"of the check {total} ({card})")
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


@contextlib.contextmanager
def one_rank_group(card):
    """A process group of this process alone (NCCL on the card)."""
    import torch
    import torch.distributed as dist
    from semantic_dsp_map_tpu_torch.parallel import distributed

    distributed.initialize()
    print(f"[sharded] process group: {dist.get_backend()}, {dist.get_world_size()} rank, torch "
          f"{torch.__version__}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))} ({card})")
    try:
        yield
    finally:
        gc.collect()  # every graph that recorded a collective goes before the communicator
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def run_sharded(counters, card) -> dict:
    """[sharded]'s runs in a process group of this process alone: [wide]'s
    sharded step at K = 63 (``check_k63_sharded``), ``drive_sharded_vkitti2``,
    [scan]'s ``drive_sharded_scan``, [merge]'s ``drive_sharded_merge`` and
    ``check_sharded_zed2``."""
    with one_rank_group(card):
        sharded = {"k63": check_k63_sharded(card)}
        sharded["vkitti2"] = drive_sharded_vkitti2(counters, card)
        sharded["scan"] = drive_sharded_scan(counters, card)
        sharded["merge"] = drive_sharded_merge(counters, card)
        sharded["zed2"] = check_sharded_zed2(counters, card)
    return sharded


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("all", "kernels", "graph", "sharded", "scan", "merge",
                                        "k31", "visible", "wide", "templates"),
                    default="all",
                    help="'kernels' stops after the per-kernel checks; 'graph' runs the build "
                         "and [graph] alone; 'sharded' the build and [sharded]'s vkitti2 and "
                         "zed2 runs alone; 'scan' the build and [scan] alone; 'merge' the "
                         "build and [merge] alone; 'k31' the build and [k31] alone; 'visible' "
                         "the build and [visible] alone; 'wide' the build and [wide] alone (its "
                         "sharded step in a process group of its own); 'templates' the build "
                         "and [templates] alone")
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
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import merge_blocks_cuda

    from semantic_dsp_map_tpu_torch.ops.templates_cuda import (
        delete_matched_cuda, template_gate_cuda,
    )

    # every kernel wrapper of the main path: the frame kernels, birth's
    # merge, template mode's gate and delete
    fns = (*step_graph.FRAME_KERNELS, merge_blocks_cuda, template_gate_cuda, delete_matched_cuda)
    # name -> (config, parameters, scene, keyword arguments of drive_graph)
    graph_paths = {
        "vkitti2": (vk_cfg, scenes.VK_PARAMS, scenes.synth_vkitti2_frame, {}),
        "zed2": (zed2_cfg, scenes.ZED2_PARAMS, scenes.synth_zed2_frame, {}),
        "coda": (coda_cfg, scenes.CODA_PARAMS, scenes.synth_coda_frame, {}),
        "vkitti2_hostile": (vk_cfg, scenes.VK_PARAMS, scenes.synth_hostile_frame, {}),
        "vkitti2_template": (vk_cfg, scenes.TPL_PARAMS, late_template_frame,
                             dict(template_path=TEMPLATES, profile_at=(TPL_LATE_CAR, TPL_LOST))),
    }

    def run_graph(name):
        cfg, params, synth, kwargs = graph_paths[name]
        out = drive_graph(name, cfg, FilterParams(**params), synth, fns, card, **kwargs)
        if kwargs:  # the birth and the rematch each ran on its replayed frame
            ran = out["template"]["branches"]
            if ran.get(TPL_LATE_CAR) != ["birth"] or ran.get(TPL_LOST) != ["rematch"]:
                raise AssertionError(f"[graph] {name}: template branches ran on frames {ran}")
        torch.cuda.empty_cache()
        return out

    if args.phase == "graph":
        graph = {name: run_graph(name) for name in graph_paths}
        print(json.dumps({"graph": graph, "card": card}))
        print(f"[card] {card}")
        return 0
    if args.phase == "sharded":
        print(json.dumps({"sharded": run_sharded(fns, card), "card": card}))
        print(f"[card] {card}")
        return 0
    if args.phase == "scan":
        scan = run_scan(fns, card)
        with one_rank_group(card):
            scan["sharded_vkitti2"] = drive_sharded_scan(fns, card)
        print(json.dumps({"scan": scan, "card": card}))
        print(f"[card] {card}")
        return 0
    if args.phase == "k31":
        print(json.dumps({"k31": check_k31(fns, card), "card": card}))
        print(f"[card] {card}")
        return 0
    if args.phase == "wide":
        wide = run_wide(fns, card)
        with one_rank_group(card):
            wide["sharded_k63"] = check_k63_sharded(card)
        print(json.dumps({"wide": wide, "card": card}))
        print(f"[card] {card}")
        return 0
    if args.phase == "templates":
        print(json.dumps({"templates": check_template_kernels(card)}))
        print(f"[card] {card}")
        return 0
    if args.phase == "visible":
        print(json.dumps({"visible": run_visible(card), "card": card}))
        print(f"[card] {card}")
        return 0
    if args.phase == "merge":
        merge = run_merge(fns, card)
        with one_rank_group(card):
            merge["sharded_vkitti2"] = drive_sharded_merge(fns, card)
        print(json.dumps({"merge": merge, "card": card}))
        print(f"[card] {card}")
        return 0
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
        # no pallas_call: the merge XLA fuses out of the JAX _insert_core
        "merge_blocks": dict(name="merge_blocks", route="cuda", source=source + "birth.cu",
                             replaces="semantic_dsp_map_tpu/ops/birth.py:279"),
        # its instance that writes each staged candidate's acceptance: the
        # JAX insert_particles' per-candidate mask ([visible])
        "merge_blocks_accepted": dict(name="merge_blocks_accepted", route="cuda",
                                      source=source + "birth.cu",
                                      replaces="semantic_dsp_map_tpu/ops/birth.py:404"),
        # the first launch of a PHD pass past its main instance: the table's
        # live planes, read once ([wide])
        "phd_live_weights": dict(name="phd_live_weights", route="cuda", source=source + "phd.cu",
                                 replaces="semantic_dsp_map_tpu/ops/phd_pallas.py:119"),
        "phd_live_tracks": dict(name="phd_live_tracks", route="cuda", source=source + "phd.cu",
                                replaces="semantic_dsp_map_tpu/ops/phd_pallas.py:269"),
    }
    # No single PyTorch call computes a frame kernel's function.
    for key in ("phd_pass_a", "phd_pass_b", "render", "front_candidates", "movable_voxels",
                "merge_blocks", "merge_blocks_accepted", "phd_live_weights", "phd_live_tracks"):
        report[key]["library_ms"] = None
    # ms / plain_ms / max_abs_err at VKITTI2 shapes, zed2_* at ZED2 shapes,
    # coda_* at the coda preset's (960 x 540, K = 3 at 8.4M voxels)
    for cfg, prefix in ((vk_cfg, ""), (zed2_cfg, "zed2_"), (coda_cfg, "coda_")):
        check_phd(cfg, report, prefix)
        check_render(cfg, report, prefix)
        check_observe(cfg, report, prefix)
    check_merge(report, card)
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

    counters = {key: fn for (key, _), fn in zip(FRAME_KERNEL_NAMES, step_graph.FRAME_KERNELS,
                                                strict=True)}
    path_counters = {**counters, "merge_blocks": merge_blocks_cuda}
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
    k31 = check_k31(fns, card)
    for key, fn in path_counters.items():
        report[key].setdefault("launches_by_path", {})["k31"] = k31["launches"][fn.__name__]
    report["merge_blocks"]["by_shape"]["k31"] = k31["merge_blocks"]
    torch.cuda.empty_cache()
    wide = run_wide(fns, card)
    full = wide["k63_full"]
    for key, fn in path_counters.items():
        report[key]["launches_by_path"]["wide_k63"] = full["launches"][fn.__name__]
    # the generic instances (K > 31) at the full grid's shapes, and the
    # passes' wide instances on real frames
    for key in ("render", "front_candidates", "movable_voxels"):
        report[key]["wide_k63"] = full[key]
    report["merge_blocks"]["wide_k63"] = full["merge"]
    report["merge_blocks_accepted"]["wide_k63"] = full["merge_accepted"]
    stencils = wide["stencils"]
    for key in ("pass_a", "pass_b"):
        report["phd_" + key]["wide"] = {**{k: v[key] for k, v in stencils.items()
                                           if k.startswith(("R", "S"))},
                                        "k63_frame": full["phd"][key]}
        by_path = report["phd_" + key]["launches_by_path"]
        by_path["wide_r12"] = stencils["r12_map"]["launches"][key + "_cuda"]
        by_path["wide_s512"] = stencils["s512_map"]["launches"][key + "_cuda"]
    report["phd_pass_a"]["wide"].update(
        first_wide_s68=stencils["switch_a_s68"], first_wide_r13=stencils["switch_a_r13"],
        full_table_max_abs_err=stencils["full_table_a"][0])
    report["phd_pass_b"]["wide"]["first_wide_s432"] = stencils["switch_b_s432"]
    # the live-plane passes run only where a pass runs its wide instance:
    # their launches are the S = 512 map's, their numbers its real frame's
    for key, fname in (("phd_live_weights", "live_weights_cuda"),
                       ("phd_live_tracks", "live_tracks_cuda")):
        n = stencils["s512_map"]["launches"][fname]
        report[key].update(stencils["live_planes"][key], launches=n,
                           launches_by_path={"wide_s512": n})
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
            report["merge_blocks"]["real_frame"] = real_frame["merge"]
        if tpl_path is not None:
            births = [(t, sw, n) for t, sw, n in sweeps if sw.stage == "birth"]
            if not births:
                raise AssertionError(f"{name}: no template birth was attempted")
            t_birth, sw, guessed = births[0]
            if guessed == 0:
                raise AssertionError(f"{name}: the template birth made no GUESSED_BORN particle")
            sweep_ms, score = time_template_sweep(dsp, synth, t_birth)
            if score != sw.score:
                raise AssertionError(f"{name}: the sweep alone scored {score}, the path {sw.score}")
            parts_ms = time_template_parts(dsp, synth, len(frame_ms))
            template = dict(birth_frame=t_birth, gate_row=sw.gate_row, score=score,
                            guessed_born=guessed, birth_frame_ms=frame_ms[t_birth],
                            sweep_ms=sweep_ms, sweeps=len(sweeps), always_on_ms=parts_ms)
            print(f"[{name}] birth on frame {t_birth}: frame {frame_ms[t_birth]:.3f} ms, the sweep "
                  f"alone {sweep_ms:.3f} ms (score {score:.6f}), {guessed} GUESSED_BORN ({card})")
            print(f"[{name}] the template work of every frame, each part alone (device-only ms, "
                  f"median of 10): " + ", ".join(f"{k} {v:.4f}" for k, v in parts_ms.items())
                  + f" ({card})")
        if args.profile:
            profile_main_path(dsp, synth, card)
        del dsp
        for key, fn in path_counters.items():
            report[key].setdefault("launches_by_path", {})[name] = launches[fn.__name__]
    torch.cuda.empty_cache()

    graph = {}
    for name in graph_paths:
        graph[name] = run_graph(name)
        for key, fn in counters.items():
            report[key].setdefault("graph_ms_by_path", {})[name] = (
                graph[name]["kernel_ms_in_replay"][key])
        for key, fn in path_counters.items():
            report[key]["launches_by_path"]["graph_" + name] = graph[name]["launches"][fn.__name__]
    for key in counters:
        report[key]["graph_ms"] = report[key]["graph_ms_by_path"]["vkitti2"]
    scan = run_scan(fns, card)
    for key, fn in path_counters.items():
        for name, out in scan["frames"].items():
            report[key]["launches_by_path"]["scan_" + name] = out["launches"][fn.__name__]
    merge = run_merge(fns, card)
    merge_entry = report["merge_blocks"]
    for name, out in merge.items():
        merge_entry["launches_by_path"]["merge_" + name] = out["merge_runs"]
        # inside a replay: the frame's launches together, and one launch
        merge_entry.setdefault("graph_ms_a_frame_by_path", {})[name] = out["kernel_ms_in_replay"]
        merge_entry.setdefault("graph_ms_by_path", {})[name] = (
            out["kernel_ms_in_replay"] / out["inserts_per_frame"])
        merge_entry.setdefault("inserts_per_frame", {})[name] = out["inserts_per_frame"]
    merge_entry["graph_ms"] = merge_entry["graph_ms_by_path"]["vkitti2"]
    visible = run_visible(card)
    for key, fname in (("phd_pass_a", "pass_a_cuda"), ("phd_pass_b", "pass_b_cuda")):
        report[key]["launches_by_path"]["visible"] = visible["phd"]["launches"][fname]
    ins = visible["insert"]
    report["merge_blocks_accepted"].update(
        launches=ins["launches"]["merge_blocks_accepted_cuda"],
        launches_by_path={"visible": ins["launches"]["merge_blocks_accepted_cuda"]},
        **{k: ins[k] for k in ("ms", "device_only_ms", "plain_ms", "max_abs_err", "bound_ms",
                               "bound_by")})

    templates = check_template_kernels(card)
    torch.cuda.empty_cache()

    rematch_launches, rematch_frame = drive_rematch(fns, card)
    replay_launches, replay_ms = drive_replay(fns, card)
    soak_launches, soak_report = drive_soak(fns, card)
    for key, fn in path_counters.items():
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
    from semantic_dsp_map_tpu_torch.parallel import distributed

    sharded = run_sharded(fns, card)
    wide["sharded_k63"] = sharded["k63"]
    sharded["slab_shapes"] = check_slab_kernels(report, card)
    print(f"[sharded] the weak-scaling report at one rank ({card})")
    sharded["weak_scaling"] = distributed.main(["--devices", "1", "--preset", "medium"])
    for key, fn in path_counters.items():
        by_path = report[key]["launches_by_path"]
        by_path["sharded_vkitti2"] = sharded["vkitti2"]["launches"][fn.__name__]
        by_path["scan_sharded_vkitti2"] = sharded["scan"]["launches"][fn.__name__]
    for key, fn in counters.items():
        report[key]["launches_by_path"]["sharded_zed2"] = (
            sharded["zed2"]["kernel_launches"][fn.__name__])
    # the merge over the whole zed2 check: its single-device and sharded frames
    merge_entry["launches_by_path"]["sharded_zed2_check"] = sharded["zed2"]["merge_runs"]
    merge_entry["launches_by_path"]["merge_sharded_vkitti2"] = sharded["merge"]["merge_runs"]
    merge_entry["graph_ms_a_frame_by_path"]["sharded_vkitti2"] = (
        sharded["merge"]["kernel_ms_in_replay"])
    merge_entry["graph_ms_by_path"]["sharded_vkitti2"] = (
        sharded["merge"]["kernel_ms_in_replay"] / sharded["merge"]["inserts_per_frame"])

    print(json.dumps({"kernels": list(report.values()), "frame_ms_median": medians,
                      "template": template, "smoothed_render_ms": smoothed_ms,
                      "real_frame": real_frame, "against": against,
                      "replay_ms_per_frame": replay_ms, "soak": soak_report,
                      "stage_profile": stage_rows, "probes": probe_rows, "bench": bench_cells,
                      "expected": expected, "rematch_frame": rematch_frame, "sharded": sharded,
                      "graph": graph, "scan": scan, "merge": merge, "k31": k31,
                      "wide": wide, "visible": visible, "templates": templates,
                      "card": card}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
