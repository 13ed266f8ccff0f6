"""The traffic rings: made from the seed alone, the same work under every
seed, and the scenes of the port's ``benchmarks/scenes.py``."""

import numpy as np
import pytest

from dspbench import traffic
from dspbench.tests.small import REDUCED
from semantic_dsp_map_tpu_torch.benchmarks import scenes
from semantic_dsp_map_tpu_torch.config import virtual_kitti2_config, zed2_config

BIG_SEED = 2**31 + 12345


def camera(preset, name):
    import dataclasses

    return traffic.Camera.of(dataclasses.asdict(preset(**REDUCED[name])))


def test_reduced_sizes_are_the_ports():
    assert REDUCED == {"vkitti2": scenes.REDUCED_VKITTI2, "zed2": scenes.REDUCED_ZED2}


@pytest.mark.parametrize("mix", ["drive", "walk", "hostile"])
def test_a_seed_gives_the_same_ring(mix):
    cam = camera(virtual_kitti2_config, "vkitti2")
    a, b = (traffic.Ring(traffic.load(mix), cam, BIG_SEED) for _ in range(2))
    for i in (0, 7, len(a) + 3):
        fa, fb = a.frame(i), b.frame(i)
        assert np.array_equal(fa.depth, fb.depth)
        assert np.array_equal(fa.cam_pos, fb.cam_pos) and fa.time == fb.time


@pytest.mark.parametrize("mix", ["drive", "walk", "hostile"])
def test_seeds_change_the_noise_and_nothing_else(mix):
    cam = camera(virtual_kitti2_config, "vkitti2")
    a = traffic.Ring(traffic.load(mix), cam, 1)
    b = traffic.Ring(traffic.load(mix), cam, BIG_SEED)
    fa, fb = a.frame(5), b.frame(5)
    assert not np.array_equal(fa.depth, fb.depth)
    assert np.abs(fa.depth - fb.depth).max() < 1.0  # noise of a few cm
    assert len(fa.masks) == len(fb.masks)
    for ma, mb in zip(fa.masks, fb.masks):
        assert np.array_equal(ma["mask"], mb["mask"]) and ma["track_id"] == mb["track_id"]


def test_the_pose_follows_the_index_and_the_image_the_ring():
    mix = traffic.load("drive")
    ring = traffic.Ring(mix, camera(virtual_kitti2_config, "vkitti2"), 3)
    n = len(ring)
    f0, f1 = ring.frame(2), ring.frame(2 + n)
    assert f0.depth is f1.depth
    assert np.allclose(f1.cam_pos - f0.cam_pos, np.array(mix["ego"]["velocity"]) * n, atol=1e-3)
    assert f1.time == pytest.approx((2 + n) * mix["frame_dt"])


@pytest.mark.parametrize("mix,preset,name,synth", [
    ("drive", virtual_kitti2_config, "vkitti2", scenes.synth_vkitti2_frame),
    ("walk", zed2_config, "zed2", scenes.synth_zed2_frame),
])
def test_the_mix_is_the_ports_scene_with_other_noise(mix, preset, name, synth):
    cfg = preset(**REDUCED[name])
    ring = traffic.Ring(traffic.load(mix), traffic.Camera.of(__import__("dataclasses").asdict(cfg)), 9)
    for t in (0, 11, 30):
        f = ring.frame(t)
        depth, masks, pos, quat = synth(cfg, t)
        assert np.array_equal(f.cam_pos, pos) and np.array_equal(f.cam_quat, quat)
        assert len(f.masks) == len(masks)
        for got, want in zip(f.masks, masks):
            assert got["track_id"] == want.track_id and got["label"] == want.label
            assert np.array_equal(got["mask"], want.mask)
            for key in ("kpts_current", "kpts_previous"):
                w = getattr(want, key)
                if w is None:
                    assert got.get(key) is None
                else:
                    np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-5)
        mover = f.masks[1]["mask"] > 0
        assert np.array_equal(f.depth[mover], depth[mover])  # set, not noisy
        assert np.abs(f.depth - depth).max() < 0.6          # the same scene, other noise
