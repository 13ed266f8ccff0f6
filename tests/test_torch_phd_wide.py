"""The port's PHD stencils at the windows and table depths past the presets'
against the JAX package: every R and S the config accepts runs on the card
(the CUDA passes' wide instances, tests/test_torch_kernels_gpu.py), and
their oracle, the plain stencils, is held here to the Pallas passes in
interpret mode at R = 9, 12 and 16 (pass A's main CUDA instance lists one
plane of the halo up to R = 13) and at S = 512 (past the shared memory of
pass B's main instance), on images that are no multiple of the Pallas tiles.
Pass A's cases are here, pass B's in tests/test_torch_phd_wide_pass_b.py
(each file takes minutes: the test workers run files in parallel).

The Pallas passes walk the slot planes in groups of ``_GS`` (4) planes, each
group an unrolled loop of (2R+1)^2 offsets: the interpreter's compile time
grows with both.  These cases run them with one group of all S planes
(``_GS`` set to S for the call): the group decides only in which order pass
A adds its slot planes (a float association, inside rtol 2e-5) and nothing
in pass B, whose sums are per slot.

Also: a half-width past the image, which the port caps at max(H, W) - 1
(``ops.phd.window_half``), against the JAX passes run at the full R; and
three frames of the dynamic scene at ``phd_neighbor_half = 12`` through the
JAX map and the port's CPU map.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu.config import tiny_test_config as j_tiny
from semantic_dsp_map_tpu.ops import phd_pallas
from semantic_dsp_map_tpu.ops.phd_pallas import pass_a_pallas, pass_b_pallas

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch.config import tiny_test_config
from semantic_dsp_map_tpu_torch.ops import phd as tphd

from test_torch_phd import _inputs, _params, _pass_a_at_the_edges, _pass_b_at_the_edges, _torch
from torch_parity import dynamic_scene, hold_scene_against_jax

torch.set_num_threads(2)

#: (R, S, table kind): windows of R = 9, 12, 16 on a 19 x 40 image and a
#: table of S = 512 planes on a 9 x 40 one; the kinds of PHD_EDGE_TABLES.
WIDE_CASES = [(9, 5, None), (9, 5, "full"), (12, 5, "patch"), (12, 5, "zero_ff"),
              (16, 5, None), (16, 5, "full"), (5, 512, None), (5, 512, "full")]


def _image(S):
    return (19, 40) if S <= 5 else (9, 40)


@pytest.mark.parametrize("R,S,kind", WIDE_CASES)
def test_pass_a_plain_matches_pallas_at_the_edges_wide(monkeypatch, R, S, kind):
    monkeypatch.setattr(phd_pallas, "_GS", S)
    _pass_a_at_the_edges(kind, False, R, S, *_image(S))


def test_window_past_the_image_matches_pallas(monkeypatch):
    window_past_the_image(monkeypatch, "pass_a")


def window_past_the_image(monkeypatch, which):
    """R = max(H, W) + 3 on a 4 x 5 image: the JAX passes run it as it is,
    the port's stencils cap it at max(H, W) - 1 (ops.phd.window_half), where
    every window already covers the image and the offsets beyond only meet
    the zero halo: the same ck, acc and flags at the other cases'
    tolerances, and every pixel sees every live entry."""
    h, w = 4, 5
    R = max(h, w) + 3
    monkeypatch.setattr(phd_pallas, "_GS", 5)
    assert tphd.window_half(R, h, w) == max(h, w) - 1 and tphd.window_half(3, h, w) == 3
    shape = dict(image_width=w, image_height=h, phd_pixel_table_slots=5, phd_neighbor_half=R)
    cfg_j, cfg_t = j_tiny(**shape), tiny_test_config(**shape)
    pj, pt = _params(False)
    table, cloud = _inputs(cfg_t, seed=4, fill=0.3, front_fill=True)
    t, c = _torch(table, cloud)
    occupied = t.meta >= 0
    ff = tphd.forgetting_factor(t.meta & 0xFF, pt.forgetting_rate, pt.max_forget_count)
    inv_sigma = 1.0 / torch.clamp(c.sigma, min=1e-6)
    obs = tuple(c.pos[..., i].contiguous() for i in range(3))
    if which == "pass_a":
        args = (t.px, t.py, t.pz, torch.where(occupied, t.weight * ff, 0.0), t.meta >> 8,
                *obs, inv_sigma, c.track)
        got = tphd.pass_a_raw(cfg_t, pt, *args)
        want = pass_a_pallas(cfg_j, pj, *(jnp.asarray(a.numpy()) for a in args),
                             interpret=True, th=8, tw=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-6)
        assert bool((got > 0).all())
    else:
        ck = tphd.stencil_pass_a(cfg_t, pt, t, c)
        args = (t.px, t.py, t.pz, torch.where(occupied, t.meta >> 8, -2),
                torch.where(occupied, ff, 0.0), inv_sigma, *obs, c.valid, c.track, ck)
        acc, right = tphd.pass_b_raw(cfg_t, pt, *args)
        acc_j, right_j = pass_b_pallas(cfg_j, pj, *(jnp.asarray(a.numpy()) for a in args),
                                       interpret=True, th=8, tw=32)
        np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), rtol=2e-5, atol=1e-6)
        np.testing.assert_array_equal(right.numpy(), np.asarray(right_j) > 0.0)
        assert bool((acc[occupied] > 0).any())


def test_three_frames_at_r12_match_jax():
    """Three frames of the dynamic scene with a window of R = 12 (625
    offsets: past the presets' 5 and 3) through the JAX map and the port's
    CPU map: counters, occ, label and track equal, the state within the
    parity tolerances."""
    params = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                  depth_noise_model_zero_order=0.2, prediction_stddev=0.0)
    diags, _, tm = hold_scene_against_jax(J.config.tiny_test_config(phd_neighbor_half=12),
                                          T.tiny_test_config(phd_neighbor_half=12), params,
                                          dynamic_scene, 3)
    assert tm.cfg.neighbor_half == 12
    assert all(d["born_count"] > 0 for d in diags) and diags[-1]["visible_count"] > 0
