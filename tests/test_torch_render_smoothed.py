"""The port's neighbour-smoothed render against the JAX package.

- ``render_occupancy_smoothed`` on the random states of
  tests/test_render_smoothed.py at K = 3 and K = 7 slots per voxel
  (max_particle_num_per_voxel_n 2 and 3), with and without a scrolled map:
  integer outputs and storage side effects equal, ``weight_sum`` at rtol
  2e-5;
- the evaluation-format RGB round trip through the port's ``viz``;
- the dynamic scene with the smoothed render on, 3 frames through both
  SemanticDSPMaps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu.frontend import build_frame_input as j_build
from semantic_dsp_map_tpu.ops.render import render_occupancy_smoothed as j_smoothed

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch import viz
from semantic_dsp_map_tpu_torch.frontend import build_frame_input as t_build
from semantic_dsp_map_tpu_torch.ops.render import render_occupancy_smoothed as t_smoothed
from semantic_dsp_map_tpu_torch.state import map_state_from_numpy, map_state_to_numpy

from test_render_smoothed import _random_state
from torch_parity import assert_states_match, dynamic_scene, jax_state_to_numpy

torch.set_num_threads(2)


def _states(n, seed, scrolled):
    cfg_j = J.config.tiny_test_config(max_particle_num_per_voxel_n=n)
    cfg_t = T.tiny_test_config(max_particle_num_per_voxel_n=n)
    js = _random_state(cfg_j, seed=seed)
    if scrolled:
        # Axis stamps 0/1 against slot stamps 1 and voxel stamps 0/1:
        # some columns wrapped out since their particles were stamped.
        rng = np.random.RandomState(seed + 100)
        sc = js.scroll.replace(
            axis_stamp_x=(rng.rand(cfg_j.nx) < 0.2).astype(np.int32) * 2,
            axis_stamp_y=(rng.rand(cfg_j.ny) < 0.2).astype(np.int32) * 2,
        )
        js = js.replace(scroll=sc)
    return cfg_j, cfg_t, js, map_state_from_numpy(jax_state_to_numpy(js), device="cpu")


@pytest.mark.parametrize("scrolled", [False, True])
@pytest.mark.parametrize("n", [2, 3])
def test_smoothed_render_matches_jax(n, scrolled):
    cfg_j, cfg_t, js, ts = _states(n, seed=0, scrolled=scrolled)
    thr = 0.2
    jp, jr = j_smoothed(cfg_j, js, thr)
    tp, tr = t_smoothed(cfg_t, ts, thr)
    for name in ("occ", "label", "track"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)), err_msg=name)
    np.testing.assert_allclose(tr.weight_sum.numpy(), np.asarray(jr.weight_sum), rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(tp.status.numpy(), np.asarray(jp.status))
    np.testing.assert_allclose(tp.weight.numpy(), np.asarray(jp.weight), rtol=2e-5, atol=1e-6)
    occ = tr.occ.numpy()
    assert (occ == 1).any() and (occ == 0).any() and (occ == -1).any()


def test_evaluation_format_roundtrip():
    """if_out_evaluation_format encodes (label, track) into RGB for instance
    voxels (semantic_dsp_map.h:1311-1315): r=label, g=track>>8,
    b=track&0xFF; background renders black."""
    _cfg_j, cfg, _js, state = _states(2, seed=3, scrolled=False)
    registry = T.LabelRegistry.default()
    _, res = t_smoothed(cfg, state, 0.2)

    params = T.FilterParams(if_out_evaluation_format=True)
    vpos = viz.voxel_positions(cfg, state.scroll)
    out = viz.colorize(cfg, params, registry, res, torch.zeros(3), vpos)

    occ, lab, trk = res.occ.numpy(), res.label.numpy(), res.track.numpy()
    sel = (occ == 1) | (occ == 2)
    rgb = out["occupied_rgb"]
    assert out["occupied_xyz"].shape == (int(sel.sum()), 3)
    bg_id = registry.label_to_id["Background"]
    inst = (lab[sel] != bg_id) & (trk[sel] <= registry.max_movable_instance_id) & (occ[sel] != 2)
    assert inst.any()
    dec_label = rgb[inst, 0].astype(np.int64)
    dec_track = (rgb[inst, 1].astype(np.int64) << 8) | rgb[inst, 2].astype(np.int64)
    np.testing.assert_array_equal(dec_label, lab[sel][inst])
    np.testing.assert_array_equal(dec_track, trk[sel][inst])
    bg = (lab[sel] == bg_id) & (occ[sel] != 2)
    assert (rgb[bg] == 0).all()
    assert (out["freespace_rgb"][:, 1] == 255).all()


def test_viz_matches_jax():
    """voxel_positions, in_fov_mask and colorize give the JAX package's
    arrays on the same render result and scroll."""
    from semantic_dsp_map_tpu import viz as jviz

    cfg_j, cfg_t, js, ts = _states(2, seed=4, scrolled=False)
    sc = dict(equiv_steps=np.array([3, -2, 5], np.int32), map_center=np.array([0.5, -0.25, 1.0], np.float32))
    js = js.replace(scroll=js.scroll.replace(**sc))
    ts = dataclasses.replace(ts, scroll=dataclasses.replace(
        ts.scroll, **{k: torch.from_numpy(v) for k, v in sc.items()}))
    _, jr = j_smoothed(cfg_j, js, 0.2)
    _, tr = t_smoothed(cfg_t, ts, 0.2)
    jpos, tpos = jviz.voxel_positions(cfg_j, js.scroll), viz.voxel_positions(cfg_t, ts.scroll)
    np.testing.assert_array_equal(tpos, jpos)
    cam = np.array([0.3, -0.1, -0.7], np.float32)
    quat = np.array([0.9833, 0.0428, 0.1737, 0.0076], np.float32)
    jfov = jviz.in_fov_mask(cfg_j, jpos, cam, quat)
    tfov = viz.in_fov_mask(cfg_t, tpos, torch.from_numpy(cam), torch.from_numpy(quat))
    np.testing.assert_array_equal(tfov, jfov)
    assert 0 < tfov.sum() < tfov.size
    for flags in (dict(), dict(visualize_with_zero_center=True)):
        jo = jviz.colorize(cfg_j, J.FilterParams(**flags), J.LabelRegistry.default(), jr, cam, jpos, jfov)
        to = viz.colorize(cfg_t, T.FilterParams(**flags), T.LabelRegistry.default(), tr,
                          torch.from_numpy(cam), tpos, tfov)
        assert jo.keys() == to.keys()
        for k in jo:
            np.testing.assert_array_equal(to[k], jo[k], err_msg=k)


SCENE_PARAMS = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                    depth_noise_model_zero_order=0.2, prediction_stddev=0.0,
                    if_use_neighbor_smoothed_occupancy=True)


def test_smoothed_frame_matches_jax():
    jm = J.SemanticDSPMap(J.config.tiny_test_config(), J.FilterParams(**SCENE_PARAMS))
    tm = T.SemanticDSPMap(T.tiny_test_config(), T.FilterParams(**SCENE_PARAMS), device="cpu")
    for t in range(3):
        jr, jd = jm.update_from_frame(j_build(jm.cfg, jm.registry, *dynamic_scene(jm.cfg, t, J.MaskKpts)))
        tr, td = tm.update_from_frame(t_build(tm.cfg, tm.registry, *dynamic_scene(tm.cfg, t, T.MaskKpts)))
        msg = f"frame {t}"
        assert {k: int(v) for k, v in td._asdict().items()} == {
            k: int(v) for k, v in jd._asdict().items()}, msg
        for name in ("occ", "label", "track"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
                                          err_msg=f"{name} {msg}")
        np.testing.assert_allclose(tr.weight_sum.numpy(), np.asarray(jr.weight_sum), rtol=2e-4,
                                   atol=1e-6, err_msg=f"weight_sum {msg}")
        assert_states_match(jax_state_to_numpy(jm.state), map_state_to_numpy(tm.state), msg)
    assert (tr.occ.numpy() == 1).any()
