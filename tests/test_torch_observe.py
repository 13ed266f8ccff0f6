"""The plain versions of the port's observe kernels against the JAX Pallas
kernels (interpret mode on the CPU): the dense candidate scan
(front_candidates) and the movable-voxel scan (movable_voxels), on
numpy-seeded stores with mixed status, stamps and tracks, a scrolled map and
an identity or rotated pose.  Outputs are u8 flags and must be equal.  Also:
the CUDA wrappers run the plain scans on CPU tensors and count no launch."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu.config import tiny_test_config as j_tiny
from semantic_dsp_map_tpu.ops.geometry import camera_matrices as j_cam
from semantic_dsp_map_tpu.ops.observe_pallas import front_candidates, movable_voxels
from semantic_dsp_map_tpu.state import init_map_state as j_init_state

from semantic_dsp_map_tpu_torch.config import tiny_test_config
from semantic_dsp_map_tpu_torch.labels import LabelRegistry
from semantic_dsp_map_tpu_torch.ops import codecs
from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices
from semantic_dsp_map_tpu_torch.ops.observe import front_candidates_plain, movable_voxels_plain
from semantic_dsp_map_tpu_torch.ops.observe_cuda import front_candidates_cuda, movable_voxels_cuda
from semantic_dsp_map_tpu_torch.state import init_scroll

torch.set_num_threads(2)

POSES = {
    "identity": ([0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]),
    # 30 degrees about y, then a small roll, off the origin
    "rotated": ([0.4, -0.2, 0.7], [0.9622502, 0.0544331, 0.2613872, 0.0555144]),
}
MAX_MOVABLE = LabelRegistry.default().max_movable_instance_id


def _store(cfg, seed):
    """Flat particle fields and axis stamps as numpy: positions spread over
    and around the frustum, status 0-3, stamps 0-3 against scroll stamps
    0-2, tracks on both sides of max_movable."""
    rng = np.random.RandomState(seed)
    n = cfg.num_voxels * cfg.slots_per_voxel
    track = rng.randint(0, 12, n)
    track = np.where(rng.rand(n) < 0.3, MAX_MOVABLE + rng.randint(-2, 12, n), track)
    return dict(
        px=(rng.randn(n) * 2).astype(np.float32),
        py=(rng.randn(n) * 2).astype(np.float32),
        pz=(rng.rand(n) * 10 - 1).astype(np.float32),
        status=rng.randint(0, 4, n).astype(np.uint8),
        stamp=rng.randint(0, 4, n).astype(np.int32),
        track=track.astype(np.int32),
        axis=[rng.randint(0, 3, k).astype(np.int32) for k in (cfg.nx, cfg.ny, cfg.nz)],
    )


def _jax_inputs(cfg, d):
    s = j_init_state(cfg)
    p = s.particles.replace(
        **{k: jnp.asarray(d[k]) for k in ("px", "py", "pz", "status", "stamp")},
        track=jnp.asarray(d["track"].astype(np.uint16)),
    )
    sc = s.scroll.replace(**{f"axis_stamp_{a}": jnp.asarray(v) for a, v in zip("xyz", d["axis"])})
    return p, sc


def _torch_inputs(cfg, d):
    scroll = dataclasses.replace(
        init_scroll(cfg, device="cpu"), **{f"axis_stamp_{a}": torch.from_numpy(v) for a, v in zip("xyz", d["axis"])}
    )
    t = {k: torch.from_numpy(d[k]) for k in ("px", "py", "pz", "status", "stamp", "track")}
    return t, codecs.axis_stamps_per_voxel(cfg, scroll)


@pytest.mark.parametrize("seed", [3, 8])
@pytest.mark.parametrize("pose", sorted(POSES))
def test_front_candidates_plain_matches_pallas(pose, seed):
    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    d = _store(cfg_t, seed)
    pos, quat = (np.asarray(a, np.float32) for a in POSES[pose])
    _, _, jr, jt = j_cam(jnp.asarray(pos), jnp.asarray(quat))
    _, _, tr, tt = camera_matrices(torch.from_numpy(pos), torch.from_numpy(quat))
    jp, jsc = _jax_inputs(cfg_j, d)
    ha_j, hc_j = front_candidates(cfg_j, jp, jsc, jr, jt, True)

    t, vax = _torch_inputs(cfg_t, d)
    args = (cfg_t, t["px"], t["py"], t["pz"], t["status"], t["stamp"], vax, tr, tt)
    ha, hc = front_candidates_plain(*args)
    assert ha.dtype == hc.dtype == torch.uint8
    np.testing.assert_array_equal(ha.numpy(), np.asarray(ha_j))
    np.testing.assert_array_equal(hc.numpy(), np.asarray(hc_j))
    # a real share of voxels on both sides of each flag
    V = cfg_t.num_voxels
    assert 0 < int(hc.sum()) < int(ha.sum()) < V

    before = front_candidates_cuda.launches
    ha_w, hc_w = front_candidates_cuda(*args)
    assert front_candidates_cuda.launches == before
    assert torch.equal(ha_w, ha) and torch.equal(hc_w, hc)


@pytest.mark.parametrize("seed", [3, 8])
def test_movable_voxels_plain_matches_pallas(seed):
    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    d = _store(cfg_t, seed)
    jp, jsc = _jax_inputs(cfg_j, d)
    hm_j = movable_voxels(cfg_j, jp, jsc, MAX_MOVABLE, True)

    t, vax = _torch_inputs(cfg_t, d)
    args = (cfg_t, t["track"], t["status"], t["stamp"], vax, MAX_MOVABLE)
    hm = movable_voxels_plain(*args)
    assert hm.dtype == torch.uint8
    np.testing.assert_array_equal(hm.numpy(), np.asarray(hm_j))
    assert 0 < int(hm.sum()) < cfg_t.num_voxels

    before = movable_voxels_cuda.launches
    assert torch.equal(movable_voxels_cuda(*args), hm)
    assert movable_voxels_cuda.launches == before
