"""The port's sharded step (``semantic_dsp_map_tpu_torch.parallel``) on the
CPU under gloo, held against the port's single-device step and the JAX
package's shard_map step on the 8 virtual CPU devices.

The ranks are spawned processes running tests/torch_shard_worker.py, which
imports no JAX.  One 8-rank spawn serves every case that needs ranks: it
makes a group of the first k ranks for each case of k ranks (D = 1, 2, 4
and 8), and the tests assert on its results.  The mirrors of
tests/test_shard_step.py use its scenes, parameters and bounds: with the
noise paths off the sharded step equals the single-device step bit for bit,
packed and unpacked, and the JAX sharded step within its test's tolerances.
``build_shard_step`` is the static path (the one the card captures), so
these cases hold it; the ``static_*`` cases hold it against its eager oracle
``build_shard_step_eager`` bit for bit, and the ``audit_*`` cases hold the
capture contract on the CPU (no host read in the captured parts, a frame of
another shape refused).
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu import config as jconfig
from semantic_dsp_map_tpu.frontend import MaskKpts as JMaskKpts
from semantic_dsp_map_tpu.frontend import build_frame_input as j_build
from semantic_dsp_map_tpu.frontend import pack_frame as j_pack
from semantic_dsp_map_tpu.labels import LabelRegistry as JLabelRegistry
from semantic_dsp_map_tpu.parallel.shard_step import build_shard_map_step
from semantic_dsp_map_tpu.parallel.shard_step import shard_caps as j_shard_caps
from semantic_dsp_map_tpu.parallel.sharding import make_mesh
from semantic_dsp_map_tpu.parallel.sharding import shard_state as j_shard_state
from semantic_dsp_map_tpu.state import init_map_state as j_init

from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts
from semantic_dsp_map_tpu_torch import config as tconfig
from semantic_dsp_map_tpu_torch.config import KEYPOINTS_BBOX3D
from semantic_dsp_map_tpu_torch.labels import LabelRegistry
from semantic_dsp_map_tpu_torch.map import build_frame_step
from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices
from semantic_dsp_map_tpu_torch.ops.projection import generate_labeled_cloud
from semantic_dsp_map_tpu_torch.parallel import distributed
from semantic_dsp_map_tpu_torch.parallel.distributed import spawn_ranks
from semantic_dsp_map_tpu_torch.parallel.shard_step import cloud_slab, shard_caps
from semantic_dsp_map_tpu_torch.state import init_map_state, map_state_to_numpy
from semantic_dsp_map_tpu_torch.tools import distributed_smoke, weakscaling_report

import torch_shard_worker as worker
from torch_parity import OBJECT_ATOL, jax_state_to_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = tconfig.tiny_test_config()
ZED2_CFG = tconfig.tiny_test_config(keypoint_mode=KEYPOINTS_BBOX3D)
OVERFLOW_CFG = tconfig.tiny_test_config(shard_route_floor=16, shard_route_headroom=0.05)
ONE_SLOT_CFG = tconfig.tiny_test_config(phd_pixel_table_slots=1)
EXACT = FilterParams(**worker.EXACT_PARAMS)

#: name -> (ranks, seed, config, parameters, frames, packed); seeds and
#: frame counts of tests/test_shard_step.py.
MAPS = {
    "exact": (8, 7, CFG, EXACT, worker.raw_frames(CFG, 4, MaskKpts), False),
    "exact_packed": (8, 7, CFG, EXACT, worker.raw_frames(CFG, 4, MaskKpts), True),
    "zed2": (8, 5, ZED2_CFG, EXACT, worker.raw_frames(ZED2_CFG, 4, MaskKpts, True, 4), False),
    "overflow": (8, 2, OVERFLOW_CFG, FilterParams(**worker.OVERFLOW_PARAMS),
                 worker.raw_frames(OVERFLOW_CFG, 3, MaskKpts), False),
    "noise_4": (4, 11, CFG, FilterParams(**worker.NOISE_PARAMS), worker.raw_frames(CFG, 4, MaskKpts),
                False),
    "noise_8": (8, 11, CFG, FilterParams(**worker.NOISE_PARAMS), worker.raw_frames(CFG, 4, MaskKpts),
                False),
    "one_rank": (1, 7, CFG, EXACT, worker.raw_frames(CFG, 4, MaskKpts), False),
    "one_slot": (8, 7, ONE_SLOT_CFG, EXACT, worker.raw_frames(ONE_SLOT_CFG, 4, MaskKpts), False),
}
#: The static path (``build_shard_step``) against its eager oracle
#: (``build_shard_step_eager``): name -> (ranks, seed, config, parameters,
#: frames, packed, the frame on which both are handed a restored state).
STATIC_NOISE = FilterParams(**worker.STATIC_NOISE_PARAMS)
STATIC = {
    **{f"static_{D}": (D, 7, CFG, EXACT, worker.raw_frames(CFG, 4, MaskKpts), False, None)
       for D in (1, 2, 4, 8)},
    **{f"static_packed_{D}": (D, 7, CFG, EXACT, worker.raw_frames(CFG, 4, MaskKpts), True, None)
       for D in (1, 8)},
    **{f"static_zed2_{D}": (D, 5, ZED2_CFG, EXACT,
                            worker.raw_frames(ZED2_CFG, 4, MaskKpts, True, 4), False, None)
       for D in (1, 8)},
    "static_noise_4": (4, 11, CFG, STATIC_NOISE, worker.raw_frames(CFG, 5, MaskKpts), False, None),
    "static_noise_packed_4": (4, 11, CFG, STATIC_NOISE, worker.raw_frames(CFG, 5, MaskKpts), True,
                              None),
    "static_restore_2": (2, 13, CFG, STATIC_NOISE, worker.raw_frames(CFG, 6, MaskKpts), False, 4),
}
#: The capture contract on the CPU: name -> (ranks, config, packed).
AUDIT = {"audit_packed_1": (1, CFG, True), "audit_4": (4, CFG, False),
         "audit_zed2_2": (2, ZED2_CFG, False)}
#: (ranks, seed, bucket capacity): 64 holds every entry, 3 and 2 overflow.
ROUTES = {"route_2": (2, 1, 64), "route_2_small": (2, 2, 3), "route_4": (4, 3, 64),
          "route_4_small": (4, 4, 2)}
#: The halo case: S, W, rows per rank, R (> rows per rank: two hops), seed.
HALO = (2, 6, 3, 5, 9)

CASES = {
    **{name: (ranks, "run_map", (cfg, params, frames, packed, seed))
       for name, (ranks, seed, cfg, params, frames, packed) in MAPS.items()},
    **{name: (ranks, "route_case", (seed, cap)) for name, (ranks, seed, cap) in ROUTES.items()},
    "halo": (8, "halo_case", HALO),
    **{name: (ranks, "static_case", (cfg, params, frames, packed, seed, restore_at))
       for name, (ranks, seed, cfg, params, frames, packed, restore_at) in STATIC.items()},
    **{name: (ranks, "static_audit_case", (cfg, EXACT, worker.raw_frames(cfg, 4, MaskKpts,
                                                                         cfg is ZED2_CFG),
                                           packed, 3))
       for name, (ranks, cfg, packed) in AUDIT.items()},
}

COUNTERS = ("block_overflow", "entry_overflow", "move_overflow", "birth_overflow")


@pytest.fixture(scope="module")
def ranks():
    """The 8-rank spawn, started in a thread so that the JAX step compiles
    meanwhile; ``ranks.result()[r][case]`` is rank r's result."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn_ranks, worker.run_cases, 8, "cpu", 300.0, (CASES,))


def _case(ranks, name):
    return [r[name] for r in ranks.result()]


def _plain(name):
    """The port's single-device step over a case's frames: (per-frame
    counters, state, render) as numpy."""
    _ranks, seed, cfg, params, frames, _packed = MAPS[name]
    registry = LabelRegistry.default()
    step = build_frame_step(cfg, params, registry)
    state = init_map_state(cfg, seed, "cpu")
    diags = []
    for raw in frames:
        state, result, diag = step(state, worker.frame_tensors(cfg, registry, raw, "cpu"))
        diags.append({k: int(v) for k, v in diag._asdict().items()})
    return diags, map_state_to_numpy(state), {k: v.numpy() for k, v in result._asdict().items()}


@pytest.fixture(scope="module")
def jax_sharded(ranks):
    """The JAX shard_map step on the 8 virtual CPU devices over the exact
    case's frames, unpacked and packed: packed -> (per-frame counters,
    state, render) as numpy."""
    jcfg = jconfig.tiny_test_config()
    jparams = jconfig.FilterParams(**worker.EXACT_PARAMS)
    registry = JLabelRegistry.default()
    raw = worker.raw_frames(jcfg, 4, JMaskKpts)
    mesh = make_mesh(8)
    out = {}
    for packed in (False, True):
        step = build_shard_map_step(jcfg, jparams, registry, mesh, packed=packed)
        state = j_shard_state(jcfg, mesh, j_init(jcfg, seed=7))
        diags = []
        for r in raw:
            state, result, diag = step(state, (j_pack if packed else j_build)(jcfg, registry, *r))
            diags.append({k: int(np.asarray(v)) for k, v in diag._asdict().items()})
        out[packed] = (diags, jax_state_to_numpy(state),
                       {k: np.asarray(v) for k, v in result._asdict().items()})
    return out


def _assert_equal_bits(got: dict, want: dict, msg: str):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{key} {msg}")


# ---------------------------------------------------------------------------
# Without processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("preset", ["tiny_test_config", "virtual_kitti2_config", "zed2_config",
                                    "coda_config", "kitti360_config"])
def test_shard_caps_equal_jax(preset, D):
    kw = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=3)
    assert shard_caps(getattr(tconfig, preset)(), FilterParams(**kw), D) == j_shard_caps(
        getattr(jconfig, preset)(), jconfig.FilterParams(**kw), D)


@pytest.mark.parametrize("bbox3d", [False, True])
def test_cloud_slabs_are_rows_of_the_whole_cloud(bbox3d):
    """Every rank's extended slab at D = 8 (R = 5 > 3 rows a rank) holds
    the whole cloud's rows bit for bit, under a rotated camera; its rows
    outside the image (the zero padding) are invalid."""
    cfg = ZED2_CFG if bbox3d else CFG
    registry = LabelRegistry.default()
    raw = worker.raw_frames(cfg, 3, MaskKpts, bbox3d=bbox3d, sky_rows=4 if bbox3d else 0)[2]
    raw = raw[:3] + (np.array([0.9, 0.1, -0.3, 0.2], np.float32) / np.sqrt(0.95),) + raw[4:]
    f = worker.frame_tensors(cfg, registry, raw, "cpu")
    r_wc, t_wc, _, _ = camera_matrices(f.cam_pos, f.cam_quat)
    max_movable = registry.max_movable_instance_id
    sky = registry.static_label_to_instance["Sky"] if bbox3d else -1
    whole = generate_labeled_cloud(
        cfg, EXACT, f.depth, f.track_raster, f.track_label_table, r_wc, t_wc, max_movable,
        sky_instance_id=sky, inst_bbox_min=f.inst_bbox_min if bbox3d else None,
        inst_bbox_max=f.inst_bbox_max if bbox3d else None)
    assert int(whole.valid.sum()) > 0
    H, R, D = cfg.height, cfg.neighbor_half, 8
    rpd = -(-H // D)
    for rank in range(D):
        slab = cloud_slab(cfg, EXACT, f, r_wc, t_wc, rank, D, max_movable, sky)
        rows = np.arange(rank * rpd - R, rank * rpd + rpd + R)
        inside = (rows >= 0) & (rows < H)
        assert not slab.valid[torch.from_numpy(~inside)].any()
        for name in ("pos", "sigma", "label", "track", "valid"):
            a = getattr(slab, name)[torch.from_numpy(inside)]
            b = getattr(whole, name)[torch.from_numpy(rows[inside])]
            assert torch.equal(a, b), (rank, name)


def test_parallel_imports_no_jax():
    code = (
        "import sys\n"
        "import semantic_dsp_map_tpu_torch.parallel.shard_step\n"
        "import semantic_dsp_map_tpu_torch.parallel.sharding\n"
        "import semantic_dsp_map_tpu_torch.parallel.distributed\n"
        "import semantic_dsp_map_tpu_torch.tools.distributed_smoke\n"
        "import semantic_dsp_map_tpu_torch.tools.weakscaling_report\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m.split('.')[0] == 'semantic_dsp_map_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_initialize_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize()
    assert not torch.distributed.is_initialized()


def test_spawn_ranks_without_a_device_raises_without_cuda(monkeypatch):
    """``spawn_ranks`` follows the package's device rule: with no device
    given it means the card and raises where there is none, before any
    process starts; the CPU is asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(distributed.mp, "get_context", lambda *a: started.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_ranks(worker.run_cases, 2, timeout=5.0, args=({},))
    assert started == []


# ---------------------------------------------------------------------------
# Routes and halos against numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_matches_numpy(ranks, name):
    """Slot layout, send slots, overflow and the round trip of _route and
    _route_back against a numpy reference."""
    D, _seed, cap = ROUTES[name]
    res = _case(ranks, name)[:D]
    slots = []
    for r in res:
        ok = r["valid"] & (r["dest"] >= 0) & (r["dest"] < D)
        slot, fill = np.full(len(ok), -1), np.zeros(D, int)
        for i in np.flatnonzero(ok):  # bucket order = original order
            d = r["dest"][i]
            if fill[d] < cap:
                slot[i] = d * cap + fill[d]
            fill[d] += 1
        np.testing.assert_array_equal(r["send_slot"], slot)
        assert r["overflow"] == ok.sum() - (slot >= 0).sum()
        slots.append(slot)
    if name.endswith("small"):
        assert sum(r["overflow"] for r in res) > 0
    for d, r in enumerate(res):
        # rank d's row s*cap + k holds the k-th entry of rank s for rank d
        want_valid = np.zeros(D * cap, bool)
        for s, (src, slot) in enumerate(zip(res, slots)):
            for i in np.flatnonzero((slot >= 0) & (slot // cap == d)):
                row = s * cap + slot[i] % cap
                want_valid[row] = True
                assert r["recv_x"][row] == src["x"][i] and r["recv_k"][row] == src["k"][i]
        np.testing.assert_array_equal(r["recv_valid"], want_valid)
    for r, slot in zip(res, slots):
        sent = slot >= 0
        np.testing.assert_array_equal(r["back_x1"], np.where(sent, r["x"] + np.float32(1), 0))
        np.testing.assert_array_equal(r["back_r"], np.where(sent, r["dest"], 0))


def test_halo_exchange_two_hops(ranks):
    """D = 8 with R = 5 > 3 rows a rank: each rank's extended table and ck
    rows equal the whole table's rows; rows beyond the image hold empty
    slots (meta -1, zero planes) and ck 1.0."""
    S, W, rpd, R, seed = HALO
    D = 8
    full = worker.whole_table(S, rpd * D, W, seed)
    for rank, got in enumerate(_case(ranks, "halo")):
        rows = np.arange(rank * rpd - R, rank * rpd + rpd + R)
        inside = (rows >= 0) & (rows < rpd * D)
        for name in ("px", "py", "pz", "weight", "meta"):
            want = np.full((S, len(rows), W), -1 if name == "meta" else 0, full[name].dtype)
            want[:, inside] = full[name][:, rows[inside]]
            np.testing.assert_array_equal(got[name], want, err_msg=f"rank {rank} {name}")
        want_ck = np.ones((len(rows), W), np.float32)
        want_ck[inside] = full["ck"][rows[inside]]
        np.testing.assert_array_equal(got["ck"], want_ck, err_msg=f"rank {rank} ck")


# ---------------------------------------------------------------------------
# The sharded step (mirrors of tests/test_shard_step.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_sharded_step_matches_single_device_and_jax(ranks, jax_sharded, packed):
    """D = 8: bit for bit the port's single-device step (state, render,
    counters), and the JAX sharded step on the same raw frames within
    tests/test_shard_step.py's tolerances; the object tables of all ranks
    equal."""
    res = _case(ranks, "exact_packed" if packed else "exact")
    diags, state, render = _plain("exact")
    tot = {k: sum(d[k] for d in diags) for k in ("visible_count", "born_count", "moved_count")}
    assert all(v > 0 for v in tot.values()), tot  # every routed path ran
    assert res[0]["diags"] == diags
    _assert_equal_bits(res[0]["state"], state, "against the single-device step")
    _assert_equal_bits(res[0]["render"], render, "against the single-device step")
    for r in res[1:]:
        assert r["diags"] == diags
        _assert_equal_bits(r["objects"], res[0]["objects"], "rank against rank 0")
    for k in COUNTERS:
        assert all(d[k] == 0 for d in res[0]["diags"]), k

    # Against the JAX step: the float tolerances of every port-against-JAX
    # frame test (torch_parity.assert_states_match).  The two single-device
    # steps already part by 4.5e-6 on one weight of 0.85 in this scene (the
    # PHD sums run in another order in XLA's CPU code); the object fit's
    # floats by a few ulp of the two frameworks' SVDs (OBJECT_ATOL).
    j_diags, j_state, j_render = jax_sharded[packed]
    assert res[0]["diags"] == j_diags
    for key, want in j_state.items():
        got = res[0]["state"][key]
        if want.dtype.kind == "f":
            atol = OBJECT_ATOL if key.startswith("objects.") and key != "objects.moved_probability" else 1e-6
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=atol, err_msg=key)
        else:
            np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=key)
    for key in ("occ", "label", "track"):
        np.testing.assert_array_equal(res[0]["render"][key], j_render[key], err_msg=key)
    np.testing.assert_allclose(res[0]["render"]["weight_sum"], j_render["weight_sum"], rtol=2e-4,
                               atol=1e-5)


def test_zed2_mode_matches_single_device(ranks):
    """ZED2 mode at D = 8: 3D-box keypoints, the bbox gate and the sky
    cull in every rank's cloud slab; equal to the single-device step."""
    res = _case(ranks, "zed2")
    diags, state, render = _plain("zed2")
    assert res[0]["diags"] == diags
    assert diags[-1]["visible_count"] > 0
    _assert_equal_bits(res[0]["state"], state, "zed2")
    _assert_equal_bits(res[0]["render"], render, "zed2")
    # the sky rows culled something
    assert diags[-1]["born_count"] < ZED2_CFG.height * ZED2_CFG.width


def test_table_cap_counts_on_the_owner_only(ranks):
    """One table slot a pixel at D = 8: the entries past it count in
    table_dropped once each, on the rank that owns their row, as the
    single-device step counts them; state and render stay bit-equal."""
    res = _case(ranks, "one_slot")
    diags, state, render = _plain("one_slot")
    assert sum(d["table_dropped"] for d in diags) > 0
    assert res[0]["diags"] == diags
    _assert_equal_bits(res[0]["state"], state, "one slot")
    _assert_equal_bits(res[0]["render"], render, "one slot")


def test_one_rank_equals_single_device(ranks):
    res = _case(ranks, "one_rank")
    diags, state, render = _plain("one_rank")
    assert res[0]["diags"] == diags
    _assert_equal_bits(res[0]["state"], state, "one rank")
    _assert_equal_bits(res[0]["render"], render, "one rank")


@pytest.mark.parametrize("D", [4, 8])
def test_noise_birth_statistical(ranks, D):
    """nb_ptc_num_per_point = 3: each rank draws its own birth noise, so the
    sharded step is held to the single-device one by the JAX test's bounds:
    births within 15%, occupied voxels within 25%.  At D = 8 (the JAX
    test's) no counter fires; at D = 4 a rank's 6 rows make 576 candidates,
    more than the 512 of a birth bucket (shard_caps' floor), and the wall
    lies in one z-slab: the birth counter fires, and only it."""
    res = _case(ranks, f"noise_{D}")
    diags, _state, render = _plain(f"noise_{D}")
    born1 = sum(d["born_count"] for d in diags)
    bornN = sum(d["born_count"] for d in res[0]["diags"])
    assert born1 > 0 and bornN > 0
    assert abs(bornN - born1) / born1 < 0.15, (born1, bornN)
    occ1 = int((render["occ"] == 1).sum())
    occN = int((res[0]["render"]["occ"] == 1).sum())
    assert occ1 > 0
    assert abs(occN - occ1) / occ1 < 0.25, (occ1, occN)
    for k in COUNTERS:
        fired = any(d[k] for d in res[0]["diags"])
        assert fired == (D == 4 and k == "birth_overflow"), (k, res[0]["diags"])
    for r in res[1:D]:
        _assert_equal_bits(r["objects"], res[0]["objects"], "rank against rank 0")


def test_overflow_counters_fire(ranks):
    """Undersized buckets at D = 8 (floor 16, headroom 0.05): the overflow
    counters fire and the map stays sane."""
    res = _case(ranks, "overflow")[0]
    seen = sum(d["entry_overflow"] + d["birth_overflow"] for d in res["diags"])
    assert seen > 0, "undersized buckets must be counted"
    assert set(np.unique(res["render"]["occ"])) <= {-1, 0, 1, 2}
    for name in ("px", "py", "pz", "weight"):
        assert np.isfinite(res["state"][f"particles.{name}"]).all(), name
    assert res["diags"][-1]["born_count"] >= 0
    assert res["diags"][-1]["visible_count"] > 0


# ---------------------------------------------------------------------------
# The static path (build_shard_step) against its eager oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(STATIC))
def test_static_step_equals_eager_sharded_step(ranks, name):
    """``build_shard_step`` (state at fixed addresses, the frame copied into
    a static input, split at the refit in superpoint mode; nothing captured
    on the CPU) bit for bit its eager oracle ``build_shard_step_eager`` on
    every rank and every frame: every tensor of the state, the state's and
    the rank's generators, the render and the nine counters; the state's
    tensors keep their addresses.  The noise cases draw from both
    generators; the restore case hands both a restored state (a generator of
    its own) on frame 4, on which the rank generator must be seeded anew as
    the oracle seeds it."""
    D, _seed, cfg, _params, _frames, _packed, _restore = STATIC[name]
    res = _case(ranks, name)[:D]
    for rank, r in enumerate(res):
        assert all(not p for p in r["parted"]), (rank, r["parted"])
        assert r["addresses_kept"], rank
        assert r["split"] == (cfg.keypoint_mode != KEYPOINTS_BBOX3D)
        assert r["diags"] == res[0]["diags"]
    tot = {k: sum(d[k] for d in res[0]["diags"]) for k in ("visible_count", "born_count")}
    assert all(v > 0 for v in tot.values()), tot
    if cfg is CFG:  # the car moves from frame 3 on
        assert sum(d["moved_count"] for d in res[0]["diags"]) > 0


@pytest.mark.parametrize("name", sorted(AUDIT))
def test_static_step_capture_contract(ranks, name):
    """The parts that the card captures (graph "fit" before the refit's SVD
    and graph "finish" after it; in bbox3d mode the one graph "step") run no
    op that reads the device to the host, the routes' ``all_to_all_single``
    and the counters' ``all_reduce`` included, on every rank; the bridge
    makes the SVD's reads and no other; a frame of another shape than the
    first raises."""
    D, cfg, _packed = AUDIT[name]
    svd = {"aten._linalg_svd.default", "aten._linalg_check_errors.default"}
    for rank, r in enumerate(_case(ranks, name)[:D]):
        assert r["split"] == (cfg.keypoint_mode != KEYPOINTS_BBOX3D)
        body = r["collectives"]["_body"]
        assert "c10d.allreduce_.default" in body and "c10d.alltoall_base_.default" in body, body
        for part, hits in r["hits"].items():
            if part != "_bridge":
                assert hits == [], (rank, part, hits)
        if r["split"]:
            ops = {op for op, _ in r["hits"]["_bridge"]}
            assert "aten._linalg_svd.default" in ops and ops <= svd, r["hits"]["_bridge"]
            assert r["collectives"]["_fit"] == r["collectives"]["_bridge"] == []
        assert r["error"] is not None and "shape" in r["error"], r["error"]


# ---------------------------------------------------------------------------
# The two tools
# ---------------------------------------------------------------------------


def _run_tool(tmp_path, monkeypatch, main):
    """Run a tool's main at 2 ranks on the CPU (gloo) in an empty working
    directory; it must write its report to --out and nothing else."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "report.json"
    code = main(["--devices", "2", "--device", "cpu", "--out", str(out)])
    assert sorted(os.listdir(tmp_path)) == ["report.json"]
    with open(out) as f:
        return code, json.load(f)


def test_distributed_smoke_writes_only_out(tmp_path, monkeypatch):
    with open(os.path.join(REPO, "DISTRIBUTED_SMOKE.json"), "rb") as f:
        before = f.read()
    code, report = _run_tool(tmp_path, monkeypatch, distributed_smoke.main)
    assert code == 0 and report["ok"], report
    assert report["ranks"] == 2 and report["backend"] == "gloo"
    assert report["identical_diags"] and report["born_last_frame"] > 0
    with open(os.path.join(REPO, "DISTRIBUTED_SMOKE.json"), "rb") as f:
        assert f.read() == before


def test_weakscaling_report_writes_only_out(tmp_path, monkeypatch):
    with open(os.path.join(REPO, "WEAKSCALING.json"), "rb") as f:
        before = f.read()
    # The tool's medium workload takes over a minute on the CPU: run its
    # report on the tiny one here.
    monkeypatch.setattr(weakscaling_report, "PRESET", "tiny")
    monkeypatch.setattr(weakscaling_report, "FRAMES", 2)
    _code, report = _run_tool(tmp_path, monkeypatch, weakscaling_report.main)
    assert report["devices"] == 2 and report["preset"] == "tiny" and report["frames"] == 2 and report["backend"] == "gloo" and report["device"] == "cpu"
    assert report["updates_per_sec_1dev"] > 0 and report["updates_per_sec_ndev"] > 0
    assert report["caps_ndev"] == shard_caps(
        dataclasses.replace(CFG, voxel_num_axis_z_n=CFG.voxel_num_axis_z_n + 1,
                            image_height=2 * CFG.height, camera_fy=2 * CFG.camera_fy,
                            camera_cy=2 * CFG.camera_cy, max_active_blocks=2 * CFG.max_active_blocks,
                            max_birth_blocks=2 * CFG.max_birth_blocks,
                            max_moving_blocks=2 * CFG.max_moving_blocks,
                            max_table_entries=2 * CFG.max_table_entries,
                            corner_gather_blocks=2 * CFG.corner_gather_blocks),
        distributed._report_params(), 2)
    with open(os.path.join(REPO, "WEAKSCALING.json"), "rb") as f:
        assert f.read() == before
