"""The port's ZED2 (bbox3d) mode against the JAX package: the labeled cloud
with the sky cull and the bbox gate, the bbox3d object update with the JAX
Gumbel draws injected, the out-of-FOV test, and the 10-frame ZED2 scene of
test_full_frame_oracle.py through both maps with the independent filter off
and on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu.config import KEYPOINTS_BBOX3D as J_BBOX3D
from semantic_dsp_map_tpu.frontend import build_frame_input as j_build
from semantic_dsp_map_tpu.objects import ObservedInstances as JObs
from semantic_dsp_map_tpu.objects import _point_out_of_fov as j_out_of_fov
from semantic_dsp_map_tpu.objects import object_level_update as j_update
from semantic_dsp_map_tpu.ops.geometry import camera_matrices as j_cam
from semantic_dsp_map_tpu.ops.projection import generate_labeled_cloud as j_cloud
from semantic_dsp_map_tpu.state import init_objects as j_init_objects

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch.config import KEYPOINTS_BBOX3D
from semantic_dsp_map_tpu_torch.frontend import build_frame_input as t_build
from semantic_dsp_map_tpu_torch.labels import BACKGROUND_INSTANCE_ID
from semantic_dsp_map_tpu_torch.objects import (
    ObservedInstances,
    _point_out_of_fov,
    object_level_update,
    ransac_draw_shape,
)
from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices
from semantic_dsp_map_tpu_torch.ops.projection import generate_labeled_cloud
from semantic_dsp_map_tpu_torch.state import ObjectTable, init_objects, map_state_to_numpy

from torch_parity import assert_states_match, jax_state_to_numpy, zed2_scene

torch.set_num_threads(2)

#: Runtime parameters of test_full_frame_oracle.py's ZED2 case.
ZED2_PARAMS = dict(
    if_consider_depth_noise=True,
    nb_ptc_num_per_point=1,
    depth_noise_model_zero_order=0.2,
    prediction_stddev=0.0,
    bayesian_movement_distance_threshold=0.2,
    bayesian_movement_increment=0.4,
    bayesian_movement_decrement=0.05,
    bayesian_movement_probability_threshold=0.3,
)
#: Object floats come out of triangle-frame fits in two frameworks.
OBJECT_ATOL = 1e-5


def _cfgs():
    return J.config.tiny_test_config(keypoint_mode=J_BBOX3D), T.tiny_test_config(
        keypoint_mode=KEYPOINTS_BBOX3D
    )


def _pose(quat, pos):
    """(JAX camera matrices, torch camera matrices) of one pose."""
    q, p = np.asarray(quat, np.float32), np.asarray(pos, np.float32)
    jm = j_cam(jnp.asarray(p), jnp.asarray(q))
    tm = camera_matrices(torch.from_numpy(p), torch.from_numpy(q))
    return jm, tm


@pytest.mark.parametrize("quat", [[1.0, 0, 0, 0], [0.9659258, 0.0, 0.2588190, 0.0]])
def test_labeled_cloud_sky_cull_and_bbox_gate_match_jax(quat):
    cfg_j, cfg_t = _cfgs()
    registry = T.LabelRegistry.default()
    sky = registry.static_label_to_instance["Sky"]
    max_movable = registry.max_movable_instance_id
    H, W = cfg_t.height, cfg_t.width
    rng = np.random.RandomState(7)
    depth = (0.5 + rng.rand(H, W) * 6).astype(np.float32)
    depth[0, :3] = np.nan
    raster = np.full((H, W), 65534, np.int32)  # Terrain
    raster[2:6] = sky
    raster[8:16, 4:20] = 3
    raster[16:20, 10:30] = 9
    raster[20:, :8] = 12  # a movable track with no box: never demoted
    bmin = np.full((65536, 3), -np.inf, np.float32)
    bmax = np.full((65536, 3), np.inf, np.float32)
    bmin[3], bmax[3] = [-1.0, -1.0, 0.5], [0.5, 1.0, 3.5]
    bmin[9], bmax[9] = [-2.0, 0.0, 1.0], [2.0, 2.0, 4.0]
    table = rng.randint(0, 20, 65536).astype(np.int32)
    (jr_wc, jt_wc, _, _), (tr_wc, tt_wc, _, _) = _pose(quat, [0.3, -0.1, 0.2])

    jp = J.FilterParams(if_consider_depth_noise=True)
    tp = T.FilterParams(if_consider_depth_noise=True)
    jc = j_cloud(cfg_j, jp, jnp.asarray(depth), jnp.asarray(raster), jnp.asarray(table),
                 jr_wc, jt_wc, max_movable, sky_instance_id=sky,
                 inst_bbox_min=jnp.asarray(bmin), inst_bbox_max=jnp.asarray(bmax))
    tc = generate_labeled_cloud(
        cfg_t, tp, torch.from_numpy(depth), torch.from_numpy(raster), torch.from_numpy(table),
        tr_wc, tt_wc, max_movable, sky_instance_id=sky,
        inst_bbox_min=torch.from_numpy(bmin), inst_bbox_max=torch.from_numpy(bmax),
    )
    for name in ("label", "track", "valid"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)), name)
    for name in ("pos", "sigma"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                   rtol=2e-6, atol=1e-6, err_msg=name)
    track = tc.track.numpy()
    # both gates bound: sky pixels culled, some box pixels demoted, some kept
    assert not tc.valid.numpy()[2:6].any()
    demoted = (raster <= max_movable) & (track == BACKGROUND_INSTANCE_ID)
    assert demoted.any() and (track == 3).any() and (track == 9).any()
    assert (track[20:, :8] == 12).all()


def test_point_out_of_fov_matches_jax():
    cfg_j, cfg_t = _cfgs()
    rng = np.random.RandomState(11)
    pts = (rng.randn(400, 3) * np.array([1.0, 0.8, 2.0]) + np.array([0, 0, 1.0])).astype(np.float32)
    pts[:5, 2] = -0.3  # on the camera plane of the unrotated pose below
    for quat in ([1.0, 0, 0, 0], [0.9238795, 0.0, 0.3826834, 0.0]):
        (_, _, jr, jt), (_, _, tr, tt) = _pose(quat, [0.1, 0.2, -0.3])
        want = np.asarray(j_out_of_fov(cfg_j, jr, jt, jnp.asarray(pts), margin=5))
        got = _point_out_of_fov(cfg_t, tr, tt, torch.from_numpy(pts), margin=5).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < len(pts)


def _bbox_obs(cfg, insts):
    """insts: list of (track, label, corners f32[4, 3])."""
    I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints
    d = dict(
        valid=np.zeros(I, bool), track=np.zeros(I, np.int32), label=np.full(I, -1, np.int32),
        kpts_curr=np.zeros((I, Kp, 3), np.float32), kpts_prev=np.zeros((I, Kp, 3), np.float32),
        kpts_count=np.zeros(I, np.int32),
    )
    for i, (track, label, corners) in enumerate(insts):
        d["valid"][i], d["track"][i], d["label"][i] = True, track, label
        d["kpts_curr"][i, :4] = corners
        d["kpts_count"][i] = 4
    return d


def test_bbox3d_object_level_update_matches_jax():
    """Two boxes over 9 frames of 0.35 s: track 3 drifts faster than its
    width (turns moving, window pushes, velocity), track 5 creeps (stays
    static); the 2 s key-corner refresh fires, and in frames 4-5 track 3's
    last corner leaves the image (FOV gate)."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = J.FilterParams(**ZED2_PARAMS), T.FilterParams(**ZED2_PARAMS)
    box = np.array([[0.0, 0.0, 1.5], [0.2, 0.0, 1.5], [0.0, -0.2, 1.5], [0.2, -0.2, 1.5]],
                   np.float32)
    (_, _, jr, jt), (_, _, tr, tt) = _pose([1.0, 0, 0, 0], [0, 0, 0])
    jo, to = j_init_objects(cfg_j), init_objects(cfg_t, device="cpu")
    I = cfg_t.max_instances_per_frame
    assert ransac_draw_shape(cfg_t) == (I, 2, 4)
    refreshed = False
    for gt in range(1, 10):
        c3 = box + np.array([0.09 * gt - 0.4, 0.013 * gt, 0], np.float32)
        if gt in (4, 5):
            c3[3, 0] = 3.0  # the last corner leaves the image
        c5 = box + np.array([0.01 * gt, 0.2, 0.4], np.float32)
        d = _bbox_obs(cfg_t, [(3, 14, c3), (5, 14, c5)])
        key = jax.random.PRNGKey(100 + gt)
        time_now, prev_time = 0.35 * gt, 0.35 * (gt - 1)
        jo = j_update(cfg_j, pj, jo, JObs(**{k: jnp.asarray(v) for k, v in d.items()}),
                      jnp.zeros(3, jnp.float32), jr, jt, jnp.float32(time_now),
                      jnp.float32(prev_time), jnp.int32(gt), key)
        draws = jax.vmap(lambda k: jax.random.gumbel(k, (2, 4)))(jax.random.split(key, I))
        to = object_level_update(
            cfg_t, pt, to, ObservedInstances(**{k: torch.from_numpy(v) for k, v in d.items()}),
            torch.zeros(3), tr, tt, torch.tensor(time_now, dtype=torch.float32),
            torch.tensor(prev_time, dtype=torch.float32), torch.tensor(gt, dtype=torch.int32),
            torch.from_numpy(np.array(draws)),
        )
        for f in dataclasses.fields(ObjectTable):
            a, b = getattr(to, f.name).numpy(), np.asarray(getattr(jo, f.name))
            if b.dtype.kind == "f":
                np.testing.assert_allclose(a, b, atol=OBJECT_ATOL, err_msg=f"{f.name} frame {gt}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{f.name} frame {gt}")
        refreshed |= bool((to.key_kpts_time[to.valid] > 0.5).any())
    row = {int(t): i for i, t in enumerate(to.track_id.tolist()) if bool(to.valid[i])}
    assert bool(to.moving[row[3]]) and bool(to.vel_valid[row[3]])
    assert not bool(to.moving[row[5]])
    assert refreshed


@pytest.mark.parametrize("independent", [False, True])
def test_zed2_scene_matches_jax(independent):
    params = dict(ZED2_PARAMS, if_use_independent_filter=independent)
    cfg_j, cfg_t = _cfgs()
    jm = J.SemanticDSPMap(cfg_j, J.FilterParams(**params))
    tm = T.SemanticDSPMap(cfg_t, T.FilterParams(**params), device="cpu")
    moved = 0
    for t in range(10):
        d, m, p, q, tt = zed2_scene(jm.cfg, t, J.MaskKpts)
        jr, jd = jm.update_from_frame(j_build(jm.cfg, jm.registry, d, m, p, q, tt))
        d, m, p, q, tt = zed2_scene(tm.cfg, t, T.MaskKpts)
        tr, td = tm.update_from_frame(t_build(tm.cfg, tm.registry, d, m, p, q, tt))

        msg = f"independent={independent} frame {t}"
        assert {k: int(v) for k, v in td._asdict().items()} == {
            k: int(v) for k, v in jd._asdict().items()
        }, msg
        for name in ("occ", "label", "track"):
            np.testing.assert_array_equal(
                getattr(tr, name).numpy(), np.asarray(getattr(jr, name)), err_msg=f"{name} {msg}"
            )
        np.testing.assert_allclose(
            tr.weight_sum.numpy(), np.asarray(jr.weight_sum), rtol=2e-4, atol=1e-6,
            err_msg=f"weight_sum {msg}",
        )
        assert_states_match(jax_state_to_numpy(jm.state), map_state_to_numpy(tm.state), msg)
        moved += int(td.moved_count)
    # the box turned moving and its particles were moved; the key corners
    # were refreshed after 2 s
    objs = tm.state.objects
    assert moved > 0
    assert bool((objs.valid & objs.moving & (objs.track_id == 4)).any())
    assert float(objs.key_kpts_time[objs.valid & (objs.track_id == 4)].max()) > 2.0
