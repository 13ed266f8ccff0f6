"""Template matching in the PyTorch port against the JAX package.

- the hypothesis sweep (``template_match``, ``template_match_bank``) on the
  box clouds of tests/test_templates.py, within that test's slack;
- the gate, and the rematch and birth stages on a hand-built object table,
  given the gate as a device tensor, with the birth noise injected: gate and
  integer state equal, floats within 1e-6;
- ``_top_rows`` (the slots' rows, picked on the device), the branch helper
  ``step_graph.slot_cond`` outside a capture, and the birth stage's draws,
  which advance the generator alike whether a birth runs or not;
- the rigid move skipping objects flagged ``to_match_previous`` in template
  mode;
- the small template scene through both SemanticDSPMaps for 3 frames, with
  a template birth that fires.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu import template_engine as jte
from semantic_dsp_map_tpu.frontend import build_frame_input as j_build
from semantic_dsp_map_tpu.map import _move_and_cleanup as j_move
from semantic_dsp_map_tpu.ops import templates as jtm
from semantic_dsp_map_tpu.ops.projection import LabeledCloud as JCloud
from semantic_dsp_map_tpu.state import init_map_state as j_init_state

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch import step_graph
from semantic_dsp_map_tpu_torch import template_engine as tte
from semantic_dsp_map_tpu_torch.frontend import build_frame_input as t_build
from semantic_dsp_map_tpu_torch.map import _move_and_cleanup as t_move
from semantic_dsp_map_tpu_torch.ops import codecs as tcodecs
from semantic_dsp_map_tpu_torch.ops import templates as ttm
from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices
from semantic_dsp_map_tpu_torch.ops.projection import generate_labeled_cloud
from semantic_dsp_map_tpu_torch.state import (
    STATUS_GUESSED_BORN,
    STATUS_INVALID,
    ObjectTable,
    map_state_from_numpy,
    map_state_to_numpy,
)

from test_templates import _box_cloud
from torch_parity import (
    TEMPLATE_SCENE_CFG,
    TEMPLATE_SCENE_GRID,
    assert_states_match,
    jax_state_to_numpy,
    static_camera,
    template_scene,
)

torch.set_num_threads(2)

TEMPLATES = "data/templates"
SWEEP_GRID = dict(grid_n=32, max_source_points=512, max_template_points=512, fs_ray_steps=96)


def _padded(a, n=512):
    pts = np.zeros((n, 3), np.float32)
    pts[: a.shape[0]] = a
    return pts, np.arange(n) < a.shape[0]


def _occupied_cells(src, use_fs, grid_n=32):
    """The source's occupied-cell count, the score's denominator."""
    vs = np.float32(jtm.TM_VOXEL_SIZE)
    origin = src.min(0) - np.float32(jtm.TM_EXPAND if use_fs else 0) * vs
    rel = (src - origin) / vs
    idx = rel.astype(np.int32)
    ok = np.all((rel >= 0) & (idx < grid_n), axis=1)
    return len({tuple(i) for i in idx[ok]})


def _both(fn_j, fn_t, use_fs, src, tpl, cam=np.zeros(3, np.float32)):
    s, sv = _padded(src)
    t, tv = _padded(tpl)
    jres = fn_j(jtm.MatchGridConfig(**SWEEP_GRID), use_fs, jnp.asarray(s), jnp.asarray(sv),
                jnp.asarray(cam), jnp.asarray(t), jnp.asarray(tv))
    tres = fn_t(ttm.MatchGridConfig(**SWEEP_GRID), use_fs, torch.from_numpy(s),
                torch.from_numpy(sv), torch.from_numpy(cam), torch.from_numpy(t), torch.from_numpy(tv))
    return jres, tres


@pytest.mark.parametrize("use_fs", [False, True])
def test_template_match_matches_jax(use_fs):
    rng = np.random.RandomState(3)
    size = np.array([2.93, 1.37, 1.61])
    src = _box_cloud(rng, 300, size, np.array([1.03, 0.47, 6.11]))
    tpl = ttm.center_cloud(_box_cloud(rng, 250, size, np.zeros(3)))
    jres, tres = _both(jtm.template_match, ttm.template_match, use_fs, src, tpl)

    occ_n = _occupied_cells(src, use_fs)
    assert abs(float(tres.score) - float(jres.score)) <= 3.0 / occ_n
    assert float(tres.score) > (0.03 if use_fs else 0.12)
    # the aligned cloud is the template under the returned transform
    Tm = tres.tmatrix.numpy()
    np.testing.assert_allclose(tres.aligned.numpy()[:250], tpl @ Tm[:3, :3].T + Tm[:3, 3], atol=1e-5)


def test_template_match_identifies_rotation():
    """A 90-degree-rotated template recovers ~90 degrees of yaw."""
    rng = np.random.RandomState(5)
    size = np.array([3.97, 1.23, 1.79])
    src = _box_cloud(rng, 400, size, np.array([0.0, 0.0, 8.0]))
    ang = np.deg2rad(90.0)
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    tpl = (ttm.center_cloud(src) @ R).astype(np.float32)
    jres, tres = _both(jtm.template_match, ttm.template_match, False, src, tpl)
    Rb = tres.tmatrix.numpy()[:3, :3]
    yaw = np.rad2deg(np.arctan2(Rb[0, 2], Rb[0, 0])) % 360
    assert abs(yaw - 90.0) <= 10.0 + 1e-6
    assert float(tres.score) > 0.35
    assert abs(float(tres.score) - float(jres.score)) <= 3.0 / _occupied_cells(src, False)


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_template_match_bank_picks_jax_index(order):
    rng = np.random.RandomState(7)
    size = np.array([3.41, 1.29, 1.63])
    src = _box_cloud(rng, 300, size, np.array([0.31, 0.2, 7.07]))
    good = ttm.center_cloud(_box_cloud(rng, 250, size, np.zeros(3)))
    small = ttm.center_cloud(_box_cloud(rng, 250, size * 0.45, np.zeros(3)))
    bank = [good, small]
    tpls, tvs = zip(*(_padded(bank[i]) for i in order))
    s, sv = _padded(src)
    cam = np.zeros(3, np.float32)
    jb, js, _ = jtm.template_match_bank(
        jtm.MatchGridConfig(**SWEEP_GRID), True, jnp.asarray(s), jnp.asarray(sv),
        jnp.asarray(cam), jnp.asarray(np.stack(tpls)), jnp.asarray(np.stack(tvs)))
    tb, ts, aligned = ttm.template_match_bank(
        ttm.MatchGridConfig(**SWEEP_GRID), True, torch.from_numpy(s), torch.from_numpy(sv),
        torch.from_numpy(cam), torch.from_numpy(np.stack(tpls)), torch.from_numpy(np.stack(tvs)))
    assert int(tb) == int(jb) == order.index(0)
    assert abs(float(ts) - float(js)) <= 3.0 / _occupied_cells(src, True)
    assert aligned.shape == (512, 3)


# ---------------------------------------------------------------------------
# Gate and stages on the small template scene's cloud
# ---------------------------------------------------------------------------


def _scene_cloud(cfg_t, registry):
    """The port's labeled cloud of frame 0 of the small template scene."""
    d, m, p, q, tt = template_scene(cfg_t, 0, T.MaskKpts)
    f = t_build(cfg_t, registry, d, m, p, q, tt)
    r_wc, t_wc, _, _ = camera_matrices(torch.from_numpy(f.cam_pos), torch.from_numpy(f.cam_quat))
    cloud = generate_labeled_cloud(
        cfg_t, T.FilterParams(), torch.from_numpy(f.depth), torch.from_numpy(f.track_raster),
        torch.from_numpy(f.track_label_table), r_wc, t_wc, registry.max_movable_instance_id,
    )
    return cloud


def _objects_np(cfg_j, rows):
    """The JAX package's initial object table as numpy, with ``rows``
    ({row: {field: value}}) written in."""
    objs = j_init_state(cfg_j).objects
    out = {f.name: np.array(getattr(objs, f.name)) for f in dataclasses.fields(objs)}
    for r, fields in rows.items():
        for k, v in fields.items():
            out[k][r] = v
    return out


def _to_j_objects(cfg_j, d):
    objs = j_init_state(cfg_j).objects
    return objs.replace(**{k: jnp.asarray(v) for k, v in d.items()})


def _to_t_objects(d):
    return ObjectTable(**{k: torch.from_numpy(v.copy()) for k, v in d.items()})


def _stage_setup():
    cfg_j = J.config.tiny_test_config(**TEMPLATE_SCENE_CFG)
    cfg_t = T.tiny_test_config(**TEMPLATE_SCENE_CFG)
    registry = T.LabelRegistry.default()
    cloud = _scene_cloud(cfg_t, registry)
    car = registry.label_to_id["Car"]
    wall = int(cloud.track[0, 0])
    moving = dict(valid=True, moving=True, has_moved_record=True, has_tmatrix=True)
    objs = _objects_np(cfg_j, {
        0: dict(moving, track_id=3, label=car, to_match_previous=True, to_match_templates=True),
        1: dict(valid=True, track_id=5, label=car, to_match_templates=True),  # no points
        2: dict(track_id=3, label=car, to_match_templates=True),              # invalid row
        3: dict(moving, track_id=wall, label=6, to_match_previous=True),      # the wall
    })

    # The car's previous particles: its observed surface 0.3 m to the side,
    # one UPDATED particle per voxel, in slot 0.
    st = {k: np.array(v) for k, v in jax_state_to_numpy(j_init_state(cfg_j)).items()}
    pts = cloud.pos[(cloud.track == 3) & cloud.valid] + torch.tensor([0.3, 0.0, 0.1])
    scroll = map_state_from_numpy(st, device="cpu").scroll
    vox, _, _, _, ok = tcodecs.global_pos_to_voxel(cfg_t, scroll, pts)
    vox, first = np.unique(vox[ok].numpy(), return_index=True)
    pts = pts[ok].numpy()[first]
    slot = vox * cfg_t.slots_per_voxel
    for name, val in (("px", pts[:, 0]), ("py", pts[:, 1]), ("pz", pts[:, 2]), ("weight", 0.5),
                      ("status", 1), ("track", 3), ("label", car), ("stamp", 1)):
        st[f"particles.{name}"][slot] = val
    st["objects"] = objs
    return cfg_j, cfg_t, registry, cloud, st


def _j_state(cfg_j, st):
    s = j_init_state(cfg_j)
    p = s.particles.replace(**{f.name: jnp.asarray(st[f"particles.{f.name}"])
                               for f in dataclasses.fields(s.particles)})
    return s.replace(particles=p, objects=_to_j_objects(cfg_j, st["objects"]))


def _j_cloud(cloud):
    return JCloud(*(jnp.asarray(x.numpy()) for x in cloud))


def test_template_gate_matches_jax():
    cfg_j, _cfg_t, registry, cloud, st = _stage_setup()
    car = registry.label_to_id["Car"]
    want = np.asarray(jte.template_gate(car, _to_j_objects(cfg_j, st["objects"]), _j_cloud(cloud)))
    got = tte.template_gate(car, _to_t_objects(st["objects"]), cloud).numpy()
    np.testing.assert_array_equal(got, want)
    # the car is birth-eligible, the wall rematch-eligible, the empty and
    # invalid rows count no point
    assert want[0, 2] == 1 and 1500 < want[0, 5] < 8000 and min(want[0, 6:8]) >= 1000
    assert want[3, 1] == 1 and want[3, 5] > 0
    assert want[1, 5] == 0 and want[2, 5] == 0


def test_template_stages_match_jax():
    cfg_j, cfg_t, registry, cloud, st = _stage_setup()
    params = dict(if_use_template_matching=True, match_score_threshold=0.2)
    jgrid = jtm.MatchGridConfig(**TEMPLATE_SCENE_GRID)
    tgrid = ttm.MatchGridConfig(**TEMPLATE_SCENE_GRID)
    jst = jte.build_template_stages(cfg_j, J.FilterParams(**params), J.LabelRegistry.default(),
                                    jgrid, jtm.TemplateBank.from_folder(TEMPLATES, jgrid))
    tst = tte.build_template_stages(cfg_t, T.FilterParams(**params), registry, tgrid,
                                    ttm.TemplateBank.from_folder(TEMPLATES, tgrid), device="cpu")
    js = _j_state(cfg_j, st)
    tobjects = _to_t_objects(st["objects"])
    ts = dataclasses.replace(map_state_from_numpy(st, device="cpu"), objects=tobjects)
    jcloud = _j_cloud(cloud)
    cam = np.zeros(3, np.float32)
    gt = 2
    key = jax.random.PRNGKey(11)

    jgate = jax.jit(jst.gate)(js.objects, jcloud)
    tgate = tst.gate(tobjects, cloud)  # the stages take the gate as a device tensor
    np.testing.assert_array_equal(tgate.numpy(), np.asarray(jgate))

    jp, j_ov = jax.jit(jst.rematch)(js.particles, js.scroll, jcloud, jnp.asarray(cam), jgate, jnp.int32(gt))
    tp, t_ov = tst.rematch(ts.particles, ts.scroll, cloud, torch.from_numpy(cam), tgate,
                           torch.tensor(gt, dtype=torch.int32))
    assert int(t_ov) == int(j_ov)
    js, ts = js.replace(particles=jp), dataclasses.replace(ts, particles=tp)
    assert_states_match(jax_state_to_numpy(js), map_state_to_numpy(ts), "after rematch")
    rematched = int((ts.particles.status == STATUS_GUESSED_BORN).sum())
    assert rematched > 0

    jp, jobj, j_ov = jax.jit(jst.birth)(js.particles, js.scroll, js.objects, jcloud,
                                        jnp.asarray(cam), jgate, jnp.int32(gt), key)
    n = jte.TB_MAX * tgrid.max_template_points * jte.GUESSED_BIRTH_COPIES
    draws = torch.from_numpy(np.array(jax.random.normal(key, (n, 3), jnp.float32)))
    tp, tobj, t_ov = tst.birth(ts.particles, ts.scroll, tobjects, cloud, torch.from_numpy(cam),
                               tgate, torch.tensor(gt, dtype=torch.int32), draws=draws)
    assert int(t_ov) == int(j_ov)
    js = js.replace(particles=jp, objects=jobj)
    ts = dataclasses.replace(ts, particles=tp, objects=tobj)
    assert_states_match(jax_state_to_numpy(js), map_state_to_numpy(ts), "after birth")
    assert int((ts.particles.status == STATUS_GUESSED_BORN).sum()) > rematched
    assert not bool(tobj.to_match_templates[0]) and bool(tobj.to_match_templates[1])


def test_a_good_rematch_counts_once_and_deletes_its_tracks_slots(monkeypatch):
    """A forced rematch match on the CPU (the car's particles 0.3 m aside,
    flagged to_match_previous; the wall eligible but with no particle):
    ``rematch_matched`` grows by one, and the delete pass sets every slot of
    the car's track INVALID, as the masked pass over the store did, and
    touches no other (the insert stubbed out, so the store shows the delete
    alone).  Run again, the car has no particle left, no match is good and
    the total stays."""
    _cfg_j, cfg_t, registry, cloud, st = _stage_setup()
    params = T.FilterParams(if_use_template_matching=True, match_score_threshold=0.2)
    tgrid = ttm.MatchGridConfig(**TEMPLATE_SCENE_GRID)
    tst = tte.build_template_stages(cfg_t, params, registry, tgrid,
                                    ttm.TemplateBank.from_folder(TEMPLATES, tgrid), device="cpu")
    ts = dataclasses.replace(map_state_from_numpy(st, device="cpu"),
                             objects=_to_t_objects(st["objects"]))
    inserted = []

    def no_insert(cfg, particles, scroll, cand, **kwargs):
        inserted.append(int(cand.valid.sum()))
        return types.SimpleNamespace(particles=particles,
                                     block_overflow=torch.zeros((), dtype=torch.int64))

    monkeypatch.setattr(tte, "_insert_core", no_insert)
    p = ts.particles
    gate = tst.gate(ts.objects, cloud)
    car = int(gate[0, 3])
    status, track = p.status.clone(), p.track.clone()
    want = status.clone()
    want.masked_fill_(track == car, STATUS_INVALID)
    assert int((want != status).sum()) > 0
    gt = torch.tensor(2, dtype=torch.int32)
    assert int(tst.counts()["rematch_matched"]) == 0
    tst.rematch(p, ts.scroll, cloud, torch.zeros(3), gate, gt)
    assert int(tst.counts()["rematch_matched"]) == 1 and inserted[0] > 0
    assert int(tst.records["rematch"].count) == 2  # the car and the wall were swept
    assert torch.equal(p.status, want) and torch.equal(p.track, track)
    tst.rematch(p, ts.scroll, cloud, torch.zeros(3), gate, gt)
    assert int(tst.counts()["rematch_matched"]) == 1 and inserted[1] == 0
    assert torch.equal(p.status, want)


def _mask(kind, O=64, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "none":
        return np.zeros(O, bool)
    if kind == "all":
        return np.ones(O, bool)
    if kind == "one_last":
        return np.arange(O) == O - 1
    if kind == "two":
        return np.isin(np.arange(O), (5, 40))
    return rng.rand(O) < {"sparse": 0.05, "dense": 0.5}[kind]


@pytest.mark.parametrize("kind", ["none", "all", "one_last", "two", "sparse", "dense"])
@pytest.mark.parametrize("cap", [tte.TB_MAX, tte.RM_MAX, 3])
def test_top_rows_matches_jax(kind, cap):
    """The first ``cap`` True rows and their validity, as JAX's: no row, one,
    exactly two, and more than the cap."""
    mask = _mask(kind, seed=cap)
    jrows, jvalid = jte._top_rows(jnp.asarray(mask), cap)
    trows, tvalid = tte._top_rows(torch.from_numpy(mask), cap)
    assert trows.dtype == torch.int64 and tvalid.dtype == torch.bool
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert int(tvalid.sum()) == min(cap, int(mask.sum()))


@pytest.mark.parametrize("pred", [False, True])
def test_slot_cond_outside_capture_is_do_or_no(pred):
    """Outside a capture the branch helper gives ``do()``'s outputs or
    ``no()``'s bit for bit (NaN payloads, -0.0 and integers included)."""
    rng = np.random.RandomState(2)
    a = rng.randn(7, 3).astype(np.float32)
    a[0, 0], a[1, 1], a[2, 2] = np.nan, -0.0, np.inf
    b = np.zeros((7, 3), np.float32)
    b[3, 1] = -0.0
    do = lambda: (torch.from_numpy(a), torch.tensor([True, False]), torch.tensor(7, dtype=torch.int64))
    no = lambda: (torch.from_numpy(b), torch.tensor([False, False]), torch.tensor(3, dtype=torch.int64))
    got = step_graph.slot_cond(torch.tensor(pred), do, no)
    want = do() if pred else no()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
        assert torch.equal(bits(g), bits(w))


def test_birth_draws_alike_with_and_without_a_birth():
    """The guessed-birth normals are drawn every frame, outside the branch:
    the generator moves on by the same offset whether the gate has a
    birth-eligible row or not, as a CUDA graph's replay moves it."""
    cfg_j, cfg_t, registry, cloud, st = _stage_setup()
    grid = ttm.MatchGridConfig(**TEMPLATE_SCENE_GRID)
    tst = tte.build_template_stages(cfg_t, T.FilterParams(if_use_template_matching=True,
                                                          match_score_threshold=0.2),
                                    registry, grid, ttm.TemplateBank.from_folder(TEMPLATES, grid),
                                    device="cpu")
    tobjects = _to_t_objects(st["objects"])
    gate = tst.gate(tobjects, cloud)
    idle = gate.clone()
    idle[:, 2] = 0  # no row birth-eligible
    states, births = [], []
    for g in (gate, idle):
        ts = dataclasses.replace(map_state_from_numpy(st, device="cpu"), objects=tobjects)
        gen = torch.Generator().manual_seed(5)
        before = int(tst.records["birth"].count)
        tst.birth(ts.particles, ts.scroll, tobjects, cloud, torch.zeros(3), g,
                  torch.tensor(2, dtype=torch.int32), gen)
        births.append(int(tst.records["birth"].count) - before)
        states.append(gen.get_state())
    assert births == [1, 0]
    want = torch.Generator().manual_seed(5)
    torch.randn((tte.TB_MAX * grid.max_template_points * tte.GUESSED_BIRTH_COPIES, 3),
                generator=want)
    assert torch.equal(states[0], states[1]) and torch.equal(states[0], want.get_state())


# ---------------------------------------------------------------------------
# The rigid move skips objects flagged for rematch in template mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("template_mode", [False, True])
def test_move_skips_to_match_previous(template_mode):
    cfg_j = J.config.tiny_test_config()
    cfg_t = T.tiny_test_config()
    K = cfg_t.slots_per_voxel
    st = {k: np.array(v) for k, v in jax_state_to_numpy(j_init_state(cfg_j)).items()}
    grid = np.arange(-1.2, 1.21, 0.8, dtype=np.float32)
    gx, gy, gz = np.meshgrid(grid, grid * 0.5, grid + 0.2)
    pos = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)
    scroll = map_state_from_numpy(st, device="cpu").scroll
    vox, _, _, _, ok = tcodecs.global_pos_to_voxel(cfg_t, scroll, torch.from_numpy(pos))
    slot = vox[ok].numpy() * K
    for name, val in (("px", pos[ok.numpy(), 0]), ("py", pos[ok.numpy(), 1]),
                      ("pz", pos[ok.numpy(), 2]), ("weight", 0.4), ("status", 2),
                      ("track", 3), ("stamp", 1)):
        st[f"particles.{name}"][slot] = val
    Tm = np.eye(4, dtype=np.float32)
    Tm[:3, 3] = [0.35113, 0.0, 0.25071]
    objs = _objects_np(cfg_j, {0: dict(valid=True, track_id=3, moving=True, has_moved_record=True,
                                       has_tmatrix=True, to_match_previous=True, tmatrix=Tm,
                                       last_obs_step=2)})
    params = dict(if_use_template_matching=template_mode, prediction_stddev=0.0)
    max_movable = T.LabelRegistry.default().max_movable_instance_id

    js = _j_state(cfg_j, dict(st, objects=objs))
    jp, jmoved, _ = jax.jit(j_move, static_argnums=(0, 1, 7))(
        cfg_j, J.FilterParams(**params), js.particles, js.scroll, js.objects, jnp.int32(2),
        jax.random.PRNGKey(0), max_movable)
    ts = dataclasses.replace(map_state_from_numpy(st, device="cpu"), objects=_to_t_objects(objs))
    tp, tmoved, _ = t_move(cfg_t, T.FilterParams(**params), ts.particles, ts.scroll,
                           ts.objects, ts.rng, max_movable)
    assert int(tmoved) == int(jmoved)
    assert (int(tmoved) == 0) == template_mode and int(tmoved) >= (0 if template_mode else 40)
    assert_states_match(jax_state_to_numpy(js.replace(particles=jp)),
                        map_state_to_numpy(dataclasses.replace(ts, particles=tp)), "move")


# ---------------------------------------------------------------------------
# The small template scene, end to end
# ---------------------------------------------------------------------------


def test_template_scene_matches_jax(monkeypatch):
    _hold_template_scene_against_jax(monkeypatch, template_scene)


def test_template_scene_static_camera_matches_jax(monkeypatch):
    """The scene without its quarter-pixel camera drift (see
    torch_parity.static_camera)."""
    _hold_template_scene_against_jax(monkeypatch, static_camera(template_scene))


def _hold_template_scene_against_jax(monkeypatch, scene):
    monkeypatch.setattr(jte, "GUESSED_BIRTH_NOISE", 0.0)
    monkeypatch.setattr(tte, "GUESSED_BIRTH_NOISE", 0.0)
    params = dict(if_use_template_matching=True, match_score_threshold=0.2,
                  nb_ptc_num_per_point=1, prediction_stddev=0.0)
    jm = J.SemanticDSPMap(J.config.tiny_test_config(**TEMPLATE_SCENE_CFG), J.FilterParams(**params))
    tm = T.SemanticDSPMap(T.tiny_test_config(**TEMPLATE_SCENE_CFG), T.FilterParams(**params), device="cpu")
    jm._templates.grid = jtm.MatchGridConfig(**TEMPLATE_SCENE_GRID)
    tm._templates.grid = ttm.MatchGridConfig(**TEMPLATE_SCENE_GRID)
    assert jm.set_template_path(TEMPLATES) == tm.set_template_path(TEMPLATES) == 1

    for t in range(3):
        jr, jd = jm.update_from_frame(j_build(jm.cfg, jm.registry, *scene(jm.cfg, t, J.MaskKpts)))
        tr, td = tm.update_from_frame(t_build(tm.cfg, tm.registry, *scene(tm.cfg, t, T.MaskKpts)))
        msg = f"frame {t}"
        assert {k: int(v) for k, v in td._asdict().items()} == {
            k: int(v) for k, v in jd._asdict().items()}, msg
        for name in ("occ", "label", "track"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
                                          err_msg=f"{name} {msg}")
        np.testing.assert_allclose(tr.weight_sum.numpy(), np.asarray(jr.weight_sum), rtol=2e-4,
                                   atol=1e-6, err_msg=f"weight_sum {msg}")
        assert_states_match(jax_state_to_numpy(jm.state), map_state_to_numpy(tm.state), msg)
        guessed = int((tm.state.particles.status == STATUS_GUESSED_BORN).sum())
        assert guessed > 0, msg  # the template birth fired on frame 0
        assert not bool(tm.state.objects.to_match_templates.any()), msg
        assert (tr.occ.numpy() == 2).any() or (tr.occ.numpy() == 1).any()
