"""Stores past 31 slots a voxel on the CPU against the JAX package: the
stores the card's generic kernel instances run (a warp a voxel), whose
oracles are the plain versions the port's CPU map runs.

The JAX map's step does not compile in a test's time at these K on a CPU
(the resample walk and the per-slot loops are unrolled; at K = 63 the
compile ran past ten minutes and 19 GB, at K = 127 further), so the port's
CPU map is held to the JAX package's independent full-frame model
(tests/oracle_full.py) on its own scene (tests/test_full_frame_oracle.py),
three frames at K = 63 and at K = 127, as the JAX map is held to it there;
K = 31 is held to the JAX map itself (tests/test_torch_k31.py).
"""

import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu.config import tiny_test_config as j_tiny
from semantic_dsp_map_tpu.frontend import build_frame_input as j_build_frame_input

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch.frontend import build_frame_input

from oracle_full import FullOracle

torch.set_num_threads(2)

#: tests/test_full_frame_oracle.py's parameters: no jitter, so the oracle's
#: frames are deterministic
SCENE_PARAMS = dict(
    if_consider_depth_noise=True,
    nb_ptc_num_per_point=1,
    depth_noise_model_zero_order=0.2,
    prediction_stddev=0.0,
)


def _oracle_scene(cfg, t, mask_cls):
    """tests/test_full_frame_oracle.py's scene (constants off every pixel and
    voxel boundary): a static wall, a far region and a tracked car moving
    by exact rigid steps, as (depth, masks, cam_pos, cam_quat, time)."""
    H, W = cfg.height, cfg.width
    depth = np.full((H, W), 1.5873, np.float32)
    depth[:4, :] = 9.5111
    static = np.full((H, W), 6, np.uint8)
    car = np.zeros((H, W), np.uint8)
    car[8:16, 4 + t: 12 + t] = 1
    depth[car > 0] = 1.2157
    dx, dy = 0.15131, 0.02071
    kpts = np.array([[0.2071 + dx * t, dy * t, 1.2157], [0.6113 + dx * t, dy * t, 1.2157],
                     [0.2071 + dx * t, -0.3041 + dy * t, 1.2157],
                     [0.6113 + dx * t, -0.3041 + dy * t, 1.2157],
                     [0.2071 + dx * t, dy * t, 1.5119]], np.float32)
    masks = [mask_cls(track_id=65535, label="static", mask=static),
             mask_cls(track_id=3, label="Car", mask=car, kpts_current=kpts,
                      kpts_previous=kpts - np.array([dx, dy, 0], np.float32))]
    cam_pos = np.array([0.02133 * t, 0, 0.26177 * t], np.float32)
    return depth, masks, cam_pos, np.array([1, 0, 0, 0], np.float32), 0.15 * t


@pytest.mark.parametrize("slots_n", [6, 7])  # K = 63, 127
def test_three_frames_at_wide_k_match_the_oracle(slots_n):
    """The port's CPU map against the JAX package's full-frame model, three
    frames: the counters, voxel stamps, occ, track and label equal, weight
    sums and weights at the oracle test's tolerances, every slot's status
    equal; capacity caps do not bind."""
    # blocks of 8 or 4 voxels at these K: the block capacities grow to match
    shape = dict(max_particle_num_per_voxel_n=slots_n, max_birth_blocks=256,
                 max_active_blocks=256, max_moving_blocks=64, corner_gather_blocks=64)
    cfg_j = j_tiny(**shape)
    params = dict(SCENE_PARAMS)
    tm = T.SemanticDSPMap(T.tiny_test_config(**shape), T.FilterParams(**params), device="cpu")
    oracle = FullOracle(cfg_j, J.FilterParams(**params), J.LabelRegistry.default())
    K = tm.cfg.slots_per_voxel
    assert K == (1 << slots_n) - 1
    moved = 0
    for t in range(3):
        depth, masks, pos, quat, time = _oracle_scene(tm.cfg, t, T.MaskKpts)
        result, diag = tm.update_from_frame(
            build_frame_input(tm.cfg, tm.registry, depth, masks, pos, quat, time))
        jdepth, jmasks, *_ = _oracle_scene(cfg_j, t, J.MaskKpts)
        ores, odiag = oracle.update(j_build_frame_input(cfg_j, oracle.registry, jdepth, jmasks,
                                                        pos, quat, time))
        msg = f"frame {t}"
        for name in ("block_overflow", "entry_overflow", "birth_overflow", "move_overflow",
                     "table_dropped"):
            assert int(getattr(diag, name)) == 0, f"{name} {msg}"
        assert (int(diag.visible_count), int(diag.born_count), int(diag.moved_count)) == (
            odiag["visible"], odiag["born"], odiag["moved"]), msg
        np.testing.assert_array_equal(tm.state.voxel_stamp.numpy(), oracle.voxel_stamp,
                                      err_msg=f"voxel_stamp {msg}")
        for name in ("occ", "track", "label"):
            np.testing.assert_array_equal(getattr(result, name).numpy(), ores[name],
                                          err_msg=f"{name} {msg}")
        np.testing.assert_allclose(result.weight_sum.numpy(), ores["weight_sum"], rtol=2e-4,
                                   atol=1e-5, err_msg=f"weight_sum {msg}")
        p = tm.state.particles
        np.testing.assert_array_equal(p.status.numpy().reshape(oracle.status.shape),
                                      oracle.status, err_msg=f"status {msg}")
        np.testing.assert_allclose(p.weight.numpy().reshape(oracle.w.shape), oracle.w,
                                   rtol=2e-4, atol=1e-6, err_msg=f"weight {msg}")
        moved += odiag["moved"]
    assert moved > 0 and int((p.status.view(-1, K) != 0).sum(1).max()) > 1
