"""Paths of the port that the other scene tests do not step, against the JAX
package on the CPU; and the two places where the packages part at full
VKITTI2 size, each held as a unit test on the numbers that part.

- both fixed movement modes with instances in the frame;
- the rematch / coast stage of the superpoint object layer (a frame on
  which the moving car's keypoints are withheld), both branches;
- the coda preset at a reduced size;
- **the empty-voxel tie.**  ``voxel_to_map_pos`` computes ``index *
  voxel_size - half``.  XLA's CPU code contracts that into one fused
  multiply-add; eager JAX, numpy, the port on the CPU and PyTorch's CUDA ops
  round the product first.  At ``voxel_size`` 0.2 the corner of the z-plane
  8 m ahead is 8.000001 unfused and 8.0 fused, so where a depth image holds the exact
  constant 8.0 (the bench scenes paint their cars so) ``corner_z <= depth``
  parts: the jitted JAX map calls such empty voxels free, the port
  unknown.  The port keeps the function as written.  The scene test runs
  with the cars 0.07 m off the boundaries; the exact scene stays as a strict
  xfail so that the tie stays visible;
- **the resampling-walk tie.**  The PHD update normalises a voxel's weights
  so that they sum to the number of observations they explain; the
  reference's resampling walk then compares the running sum with that very
  integer.  The packages' weights agree to 1-2 ulp, so the last slot's fate
  can part (one particle in 35,000 births on frame 2 of the hostile scene).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu.ops import birth as jbirth
from semantic_dsp_map_tpu.ops import codecs as jcodecs
from semantic_dsp_map_tpu.state import init_map_state as j_init

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch.benchmarks import scenes
from semantic_dsp_map_tpu_torch.config import MOVEMENT_ALWAYS, MOVEMENT_NEVER
from semantic_dsp_map_tpu_torch.ops import birth as tbirth
from semantic_dsp_map_tpu_torch.ops import codecs as tcodecs
from semantic_dsp_map_tpu_torch.state import init_map_state as t_init

from torch_parity import (
    OBJECT_ATOL_FAR, dynamic_scene, hold_scene_against_jax, occ_counts, without_keypoints,
)

torch.set_num_threads(2)

SCENE_PARAMS = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                    depth_noise_model_zero_order=0.2, prediction_stddev=0.0)


# ---------------------------------------------------------------------------
# Movement modes, rematch / coast, coda
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [MOVEMENT_ALWAYS, MOVEMENT_NEVER], ids=["always", "never"])
def test_fixed_movement_modes_match_jax(mode):
    """10 frames of the dynamic scene with the object layer's decision
    hardwired: counters, occ and the object table (moving,
    moved_probability, has_moved_record, window) equal to the JAX map's."""
    seen = []

    def on_frame(t, jm, tm):
        o = tm.state.objects
        seen.append((bool(o.moving[0]), bool(o.has_moved_record[0]), float(o.moved_probability[0]),
                     int(o.win_count[0])))

    diags, _, _ = hold_scene_against_jax(
        J.config.tiny_test_config(movement_mode=mode), T.tiny_test_config(movement_mode=mode),
        SCENE_PARAMS, dynamic_scene, 10, on_frame=on_frame)
    moved = [d["moved_count"] for d in diags]
    # the probability is never touched by a fixed mode
    assert all(p == 0.5 for _, _, p, _ in seen)
    assert all(rec for _, rec, _, _ in seen[1:])
    if mode == MOVEMENT_NEVER:
        assert moved == [0] * 10
        assert not any(moving for moving, _, _, _ in seen) and seen[-1][3] == 0
    else:
        # moving from the second frame the car is seen, one window entry a frame
        assert moved[0] == 0 and all(m > 0 for m in moved[1:])
        assert all(moving for moving, _, _, _ in seen[1:])
        assert [w for _, _, _, w in seen] == [0, 1, 2, 3, 4, 5, 5, 5, 5, 5]


@pytest.mark.parametrize("lost,branch", [(5, "coast"), (3, "rematch")])
def test_lost_keypoints_coast_or_rematch_matches_jax(lost, branch):
    """The car loses its keypoints on one frame after it started moving.
    With a velocity (two window entries, from frame 3) the object coasts:
    its transform is the velocity translation over the default interval.
    Without one it is flagged for cloud rematching and keeps its transform."""
    table = {}

    def on_frame(t, jm, tm):
        o, jo = tm.state.objects, jm.state.objects
        table[t] = dict(tmatrix=o.tmatrix[0].numpy().copy(), velocity=o.velocity[0].numpy().copy(),
                        vel_valid=bool(o.vel_valid[0]), flagged=bool(o.to_match_previous[0]),
                        moving=bool(o.moving[0]), win=int(o.win_count[0]))
        assert bool(np.asarray(jo.to_match_previous)[0]) == table[t]["flagged"]

    diags, _, _ = hold_scene_against_jax(
        J.config.tiny_test_config(), T.tiny_test_config(), SCENE_PARAMS,
        without_keypoints(dynamic_scene, (lost,)), 10, on_frame=on_frame)
    before, at, after = table[lost - 1], table[lost], table[lost + 1]
    assert before["moving"] and at["moving"] and at["win"] == before["win"]  # no fit, no push
    if branch == "coast":
        assert before["vel_valid"] and not at["flagged"]
        from semantic_dsp_map_tpu_torch.objects import DEFAULT_PREDICT_DT

        want = np.eye(4, dtype=np.float32)
        want[:3, 3] = before["velocity"] * np.float32(DEFAULT_PREDICT_DT)
        np.testing.assert_array_equal(at["tmatrix"], want)
        assert np.abs(want[:3, 3]).max() > 0.1  # a real translation, not the identity
    else:
        assert not before["vel_valid"] and at["flagged"]
        np.testing.assert_array_equal(at["tmatrix"], before["tmatrix"])
    # the fit is back on the next frame: the flag is cleared, the window grows
    assert not after["flagged"] and after["win"] == at["win"] + 1
    assert diags[lost]["moved_count"] > 0 and diags[lost + 1]["moved_count"] > 0


CODA_REDUCED = dict(
    voxel_num_axis_x_n=5, voxel_num_axis_y_n=5, voxel_num_axis_z_n=5,
    max_particle_num_per_voxel_n=2, voxel_size=0.6,
    camera_fx=569.8286 / 8, camera_fy=565.4818 / 8, camera_cx=439.2660 / 8,
    camera_cy=360.5810 / 8, image_width=120, image_height=67,
    max_active_blocks=256, max_table_entries=1 << 15, max_birth_blocks=256,
    corner_gather_blocks=32, max_moving_blocks=32,
)


def test_coda_config_reduced_matches_jax():
    """The coda preset (K = 3, always-moving objects, depth range 10 m) with
    its image and intrinsics divided by 8 and a 32 x 32 x 32 grid of 0.6 m
    voxels (the wall at 7.5 m is inside): 6 frames of the coda scene equal
    to the JAX map's."""
    jcfg, tcfg = J.config.coda_config(**CODA_REDUCED), T.coda_config(**CODA_REDUCED)
    assert tcfg.movement_mode == MOVEMENT_ALWAYS and tcfg.slots_per_voxel == 3
    diags, _, tm = hold_scene_against_jax(
        jcfg, tcfg, scenes.CODA_PARAMS | dict(prediction_stddev=0.0), scenes.synth_coda_frame, 6,
        object_atol=OBJECT_ATOL_FAR)
    assert diags[0]["born_count"] > 0 and diags[-1]["visible_count"] > 0
    assert all(d["moved_count"] > 0 for d in diags[1:])
    assert bool(tm.state.objects.moving[0])


# ---------------------------------------------------------------------------
# The empty-voxel tie (free against unknown at full VKITTI2 size)
# ---------------------------------------------------------------------------

#: A 128 x 32 x 128 grid of 0.2 m voxels around the quarter-size VKITTI2
#: camera: 524,288 voxels; the car depths 8, 10 and 12 m are z-planes 104,
#: 114 and 124 of it.
TIE_CFG = dict(
    voxel_num_axis_x_n=7, voxel_num_axis_y_n=5, voxel_num_axis_z_n=7, voxel_size=0.2,
    camera_fx=725.0087 / 4, camera_fy=725.0087 / 4, camera_cx=620.5 / 4, camera_cy=187.0 / 4,
    image_width=310, image_height=94, max_moving_blocks=8, max_active_blocks=512,
    max_table_entries=1 << 16, max_birth_blocks=512, corner_gather_blocks=1024,
)


def test_voxel_corner_is_the_unfused_jax_expression():
    """The port's voxel corners have the bits of the JAX function run as
    written (un-jitted: product rounded, then the subtraction), on every
    voxel of the 0.2 m grid; on the planes at the cars' depths that is one
    ulp above the depth the scene paints."""
    jcfg, tcfg = J.config.virtual_kitti2_config(**TIE_CFG), T.virtual_kitti2_config(**TIE_CFG)
    v = np.arange(tcfg.num_voxels, dtype=np.int32)
    with jax.disable_jit():
        want = np.asarray(jcodecs.voxel_to_global_pos(jcfg, j_init(jcfg, 0).scroll, jnp.asarray(v)))
    got = tcodecs.voxel_to_global_pos(tcfg, t_init(tcfg, 0, "cpu").scroll, torch.from_numpy(v)).numpy()
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    plane = got.reshape(tcfg.nz, tcfg.ny, tcfg.nx, 3)[..., 2]
    for zi, depth in ((104, 8.0), (114, 10.0), (124, 12.0)):
        z = np.unique(plane[zi])
        assert z.size == 1 and z[0] == np.nextafter(np.float32(depth), np.float32(np.inf))
        # one fused multiply-add lands on the constant itself
        assert np.float32(np.float64(np.float32(zi)) * np.float64(np.float32(0.2))
                          - np.float64(np.float32(12.8))) == np.float32(depth)


def _tie_scene(offset):
    return lambda cfg, t, mask_cls: scenes.synth_hostile_frame(
        cfg, t, mask_cls, car_depth_offset=offset)


def _hold_tie_scene(offset):
    counts = []
    hold_scene_against_jax(
        J.config.virtual_kitti2_config(**TIE_CFG), T.virtual_kitti2_config(**TIE_CFG),
        dict(scenes.VK_PARAMS, prediction_stddev=0.0), _tie_scene(offset), 2,
        on_frame=lambda t, jm, tm: counts.append(t), object_atol=OBJECT_ATOL_FAR)
    return counts


def test_hostile_scene_on_the_fine_grid_matches_jax():
    """Frames 0-1 of the hostile scene on the 524,288-voxel grid, the cars
    0.07 m off the voxel boundaries: free, occupied and unknown voxels
    (``occ`` itself) and all counters equal to the JAX map's."""
    assert _hold_tie_scene(0.07) == [0, 1]


@pytest.mark.xfail(strict=True, reason="XLA's CPU code fuses index * voxel_size - half into one "
                   "multiply-add: with the cars' depths on voxel boundaries the jitted JAX map "
                   "calls 120 empty voxels free that the function as written leaves unknown")
def test_hostile_scene_with_exact_car_depths_parts_from_jitted_jax():
    _hold_tie_scene(0.0)


def test_exact_car_depths_part_only_in_free_against_unknown():
    """What the tie reaches and what it does not: on frame 0 of the exact
    scene every counter and the occupied count agree; the port's free
    voxels are a subset of the JAX map's, and all the others lie on the
    planes of the cars' depths."""
    jcfg, tcfg = J.config.virtual_kitti2_config(**TIE_CFG), T.virtual_kitti2_config(**TIE_CFG)
    params = dict(scenes.VK_PARAMS, prediction_stddev=0.0)
    jm = J.SemanticDSPMap(jcfg, J.FilterParams(**params))
    tm = T.SemanticDSPMap(tcfg, T.FilterParams(**params), device="cpu")
    jr, jd = jm.update(*scenes.synth_hostile_frame(jcfg, 0, J.MaskKpts), time=0.0)
    tr, td = tm.update(*scenes.synth_hostile_frame(tcfg, 0, T.MaskKpts), time=0.0)
    assert {k: int(v) for k, v in td._asdict().items()} == {
        k: int(v) for k, v in jd._asdict().items()}
    jocc, tocc = np.asarray(jr.occ), tr.occ.numpy()
    assert occ_counts(jocc)["occupied"] == occ_counts(tocc)["occupied"]
    parted = np.nonzero(jocc != tocc)[0]
    assert 0 < parted.size < 1000
    assert (jocc[parted] == 0).all() and (tocc[parted] == -1).all()
    zi = parted >> (tcfg.voxel_num_axis_x_n + tcfg.voxel_num_axis_y_n)
    assert set(zi.tolist()) <= {104, 114, 124}


# ---------------------------------------------------------------------------
# The resampling-walk tie (one birth on frame 2 of the full-size hostile scene)
# ---------------------------------------------------------------------------

#: The seven weights of voxel 6,899,569 before the resampling walk of frame 2
#: of the hostile scene at ``virtual_kitti2_config()``, as the jitted JAX map
#: and as the port's CPU path hold them: 1-2 ulp apart, all slots UPDATED.
#: They explain eight observations, so they sum to 8 - 5e-7 and to 8.
WALK_WEIGHTS_JAX = ["0x1.819fe8p+0", "0x1.45359ep+0", "0x1.b2a6ecp+0", "0x1.5caa26p+0",
                    "0x1.032f28p+1", "0x1.3441f6p-4", "0x1.036e98p-4"]
WALK_WEIGHTS_PORT = ["0x1.819fecp+0", "0x1.4535a0p+0", "0x1.b2a6f0p+0", "0x1.5caa28p+0",
                     "0x1.032f28p+1", "0x1.3441fap-4", "0x1.036e9ap-4"]


def test_resampling_walk_tie_is_in_the_weights_not_in_the_walk():
    """Both packages' walks agree on either set of weights; the sets differ
    by 1-2 ulp (inside the float tolerance of every kernel test) and the
    walk's last threshold is the sum itself: slot 6 survives on the port's
    weights and is deleted on the JAX map's."""
    from semantic_dsp_map_tpu_torch.state import STATUS_INVALID, STATUS_UPDATED

    jcfg, tcfg = J.config.virtual_kitti2_config(), T.virtual_kitti2_config()
    status = np.full((1, 7), STATUS_UPDATED, np.int32)
    target = np.ones(1, bool)
    out = {}
    for name, hexes in (("jax", WALK_WEIGHTS_JAX), ("port", WALK_WEIGHTS_PORT)):
        w = np.array([[float.fromhex(h) for h in hexes]], np.float32)
        js, jw = jbirth.resample_slots(jcfg, jnp.asarray(status), jnp.asarray(w), jnp.asarray(target))
        ts, tw = tbirth.resample_slots(tcfg, torch.from_numpy(status), torch.from_numpy(w),
                                       torch.from_numpy(target))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert tw.numpy().tobytes() == np.asarray(jw).tobytes()
        out[name] = ts.numpy()[0].tolist()
    rel = np.abs(np.array([float.fromhex(a) / float.fromhex(b) - 1
                           for a, b in zip(WALK_WEIGHTS_JAX, WALK_WEIGHTS_PORT)]))
    assert rel.max() < 4e-7
    keep = STATUS_UPDATED
    assert out["port"] == [keep] * 5 + [STATUS_INVALID, keep]
    assert out["jax"] == [keep] * 5 + [STATUS_INVALID, STATUS_INVALID]
