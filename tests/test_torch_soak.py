"""The port's soak tool at the tiny static-mode config: 12 frames along a
street scaled to the tiny map, a checkpoint half-way, a restore into a second
map, and equal occupancy five frames later; its street against the JAX
tool's."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch.tools import soak

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def tiny_street(cfg, t, speed):
    """The street of ``soak.make_frame`` scaled to the tiny map (4 x 2 x 4 m):
    the ground 0.6 m below the camera, walls at x = +-1.3 m, nothing beyond 9 m."""
    H, W = cfg.height, cfg.width
    v = np.arange(H, dtype=np.float32)[:, None]
    u = np.arange(W, dtype=np.float32)[None, :]
    depth = np.full((H, W), 9.0, np.float32)
    ground = cfg.fy * 0.6 / np.maximum(v - cfg.cy, 1e-3)
    depth = np.minimum(depth, np.where(v > cfg.cy, ground, depth))
    xr = (u - cfg.cx) / cfg.fx
    wall = np.where(np.abs(xr) > 1e-3, 1.3 / np.maximum(np.abs(xr), 1e-3), 9.0)
    depth = np.minimum(depth, wall.astype(np.float32))
    depth += np.random.RandomState(t).randn(H, W).astype(np.float32) * 0.02
    static = np.broadcast_to(np.where(np.abs(xr) > 0.12, 5, 6).astype(np.uint8), (H, W)).copy()
    masks = [T.MaskKpts(track_id=65535, label="static", mask=static)]
    return (depth, masks, np.array([0.0, 0.0, speed * t], np.float32),
            np.array([1.0, 0, 0, 0], np.float32))


def test_soak_checkpoint_restore_at_tiny():
    cfg = T.tiny_test_config(consider_instance=False)
    report = soak.run_soak(cfg, soak.soak_params(), 12, 0.3, "cpu", verbose=False,
                           frame_fn=tiny_street)
    assert report["frames"] == 12 and report["device"] == "cpu"
    assert report["resumed_occ_equal"] is True
    assert report["occupied_in_ego_window"] is True and report["behind_region_unknown"] is True
    assert report["occupied_final"] > 0 and report["occupied_at_checkpoint"] > 0
    assert report["resumed_occupied_half_plus_5"] == report["occupied_final"]  # 6 + 5 = 11, the last
    assert report["checkpoint_mb"] > 0 and report["sec_per_frame"] > 0
    n = cfg.num_voxels * cfg.slots_per_voxel
    assert report["state_bytes"] > 27 * n + 4 * cfg.num_voxels  # 27 B per slot, 4 per voxel
    for key in ("meters", "fps"):
        assert report[key] > 0


def test_soak_needs_room_after_the_checkpoint_and_a_device():
    cfg = T.tiny_test_config(consider_instance=False)
    with pytest.raises(ValueError, match="--frames"):
        soak.run_soak(cfg, soak.soak_params(), 8, 0.3, "cpu", verbose=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            soak.run_soak(cfg, soak.soak_params(), 12, 0.3, verbose=False)


@pytest.mark.parametrize("t", [0, 7])
def test_soak_street_is_the_jax_tool_s(t):
    """``make_frame`` gives the JAX tool's frame."""
    spec = importlib.util.spec_from_file_location(
        "soak_kitti360", os.path.join(REPO, "tools", "soak_kitti360.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    cfg_j = J.config.tiny_test_config(consider_instance=False, image_width=64, image_height=48)
    cfg_t = T.tiny_test_config(consider_instance=False, image_width=64, image_height=48)
    with np.errstate(divide="ignore"):
        jd, jm, jp, jq = jtool.make_frame(cfg_j, t, 0.7)
    td, tm, tp, tq = soak.make_frame(cfg_t, t, 0.7)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tm[0].mask, jm[0].mask)
    assert (tm[0].track_id, tm[0].label) == (jm[0].track_id, jm[0].label)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tq, jq)
    assert soak.soak_params() == T.FilterParams(
        if_consider_depth_noise=True, nb_ptc_num_per_point=1, depth_noise_model_zero_order=0.2,
        depth_noise_model_first_order=0.01, occupancy_threshold=0.3)
