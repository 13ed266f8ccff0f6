"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
device at the tiny config.

This file imports no JAX, so it also runs where only PyTorch is installed
(the repo's conftest imports JAX, hence ``--noconftest``):

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_gpu.py

Without a CUDA device every test here skips: a CUDA kernel has no CPU mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, SemanticDSPMap, tiny_test_config
from semantic_dsp_map_tpu_torch.config import KEYPOINTS_BBOX3D
from semantic_dsp_map_tpu_torch.ops import codecs, phd, phd_cuda
from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices
from semantic_dsp_map_tpu_torch.ops.observe import front_candidates_plain, movable_voxels_plain
from semantic_dsp_map_tpu_torch.ops.observe_cuda import front_candidates_cuda, movable_voxels_cuda
from semantic_dsp_map_tpu_torch.ops.projection import LabeledCloud
from semantic_dsp_map_tpu_torch.ops.render import render_core_plain
from semantic_dsp_map_tpu_torch.ops.render_cuda import render_core_cuda
from semantic_dsp_map_tpu_torch.state import init_map_state
from semantic_dsp_map_tpu_torch.step_graph import kernel_runs

from torch_parity import (
    GATE_CAR, PHD_EDGE_TABLES, RENDER_GENERIC_EDGES, STORE_EDGES, TEMPLATE_DELETE_EDGES,
    TEMPLATE_GATE_EDGES, ZERO_FF_ENTRY, deleted_as_expected, particle_store, phd_table_cloud,
    render_generic_store, render_store, template_delete_case, template_gate_tensors, zed2_scene,
)

CASES = [(False, False, 0.4), (True, False, 0.4), (False, True, 0.12)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _phd_inputs(cfg, device, seed=0, fill=0.4, front_fill=False, kind=None):
    """The table/cloud generator of tests/test_phd_pallas.py, on ``device``."""
    table, cloud = phd_table_cloud(cfg.phd_pixel_table_slots, cfg.height, cfg.width,
                                   seed, fill, front_fill, kind)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    t = phd.PixelTable(**{k: T(v) for k, v in table.items()},
                       dropped=torch.zeros((), dtype=torch.int64, device=device))
    return t, LabeledCloud(**{k: T(v) for k, v in cloud.items()})


@pytest.mark.gpu
@pytest.mark.parametrize("R", [5, 3])  # VKITTI2 and BOOST-mode (ZED2) half-widths
@pytest.mark.parametrize("independent,front_fill,fill", CASES)
def test_phd_kernels_match_plain(cuda, independent, front_fill, fill, R):
    cfg = tiny_test_config(phd_pixel_table_slots=4, phd_neighbor_half=R)
    params = FilterParams(detection_probability=0.9, noise_number=0.1,
                          if_use_independent_filter=independent, if_consider_depth_noise=True)
    t, c = _phd_inputs(cfg, cuda, fill=fill, front_fill=front_fill)
    ck_p = phd.stencil_pass_a(cfg, params, t, c)
    ck_k = phd.stencil_pass_a_any(cfg, params, t, c)
    torch.testing.assert_close(ck_k, ck_p, rtol=2e-5, atol=1e-6)
    nw_p, nf_p = phd.stencil_pass_b(cfg, params, t, c, ck_p)
    nw_k, nf_k = phd.stencil_pass_b_any(cfg, params, t, c, ck_p)
    torch.testing.assert_close(nw_k, nw_p, rtol=2e-5, atol=1e-6)
    assert torch.equal(nf_k, nf_p)


def _pass_b_args(cfg, params, t, c):
    """The arguments ops.phd._pass_b hands to pass B, with the plain ck."""
    ck = phd.stencil_pass_a(cfg, params, t, c)
    occupied = t.meta >= 0
    ff = phd.forgetting_factor(t.meta & 0xFF, params.forgetting_rate, params.max_forget_count)
    ff_eff = occupied.float() if params.if_use_independent_filter else torch.where(occupied, ff, 0.0)
    return ck, (cfg, params, t.px, t.py, t.pz, torch.where(occupied, t.meta >> 8, -2), ff_eff,
                1.0 / torch.clamp(c.sigma, min=1e-6),
                *(c.pos[..., i].contiguous() for i in range(3)), c.valid, c.track, ck)


def _pass_a_args(cfg, params, t, c):
    """The arguments ops.phd._pass_a hands to pass A."""
    occupied = t.meta >= 0
    ff = phd.forgetting_factor(t.meta & 0xFF, params.forgetting_rate, params.max_forget_count)
    w = t.weight if params.if_use_independent_filter else t.weight * ff
    return (cfg, params, t.px, t.py, t.pz, torch.where(occupied, w, 0.0), t.meta >> 8,
            *(c.pos[..., i].contiguous() for i in range(3)),
            1.0 / torch.clamp(c.sigma, min=1e-6), c.track)


def _check_pass_a(args):
    """The kernel within rtol 2e-5 / atol 1e-6 of the plain version (it adds
    a pixel's terms in list order, the plain version offset by offset), one
    launch counted, and a second launch with the first one's bits."""
    want = phd.pass_a_raw(*args)
    before = phd_cuda.pass_a_cuda.launches
    got = phd_cuda.pass_a_cuda(*args)
    torch.cuda.synchronize()
    assert phd_cuda.pass_a_cuda.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
    again = phd_cuda.pass_a_cuda(*args)
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("R", [5, 3])
@pytest.mark.parametrize("kind,independent",
                         [(kind, False) for kind in (*PHD_EDGE_TABLES, None)] + [(None, True)])
def test_pass_a_kernel_at_the_edges(cuda, kind, independent, R):
    """Pass A on an image that is no multiple of its tile (37 x 53), an odd
    slot count, and the tables its list has to get right: every entry
    occupied, none (a tile writes its zeros and ends), one patch, and
    occupied entries without weight (forget count at its maximum)."""
    cfg = tiny_test_config(image_width=53, image_height=37, phd_pixel_table_slots=5,
                           phd_neighbor_half=R)
    params = FilterParams(detection_probability=0.9, noise_number=0.1,
                          if_use_independent_filter=independent, if_consider_depth_noise=True)
    t, c = _phd_inputs(cfg, cuda, seed=4, fill=0.3, front_fill=True, kind=kind)
    args = _pass_a_args(cfg, params, t, c)
    ck = _check_pass_a(args)
    weff = args[5]
    if kind == "empty":
        assert not ck.any()
    elif kind == "full":
        assert (ck > 0).all()
    if kind != "empty" and not independent:
        assert bool(((t.meta >= 0) & (weff == 0)).any())
    ck_p = phd.stencil_pass_a(cfg, params, t, c)
    ck_k = phd.stencil_pass_a_any(cfg, params, t, c)
    torch.testing.assert_close(ck_k, ck_p, rtol=2e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("S,R,h,w", [(12, 5, 40, 70), (12, 8, 40, 70), (40, 5, 19, 40),
                                      (12, 0, 9, 33)])
@pytest.mark.parametrize("kind", ["full", None])
def test_pass_a_kernel_list_capacity(cuda, kind, S, R, h, w):
    """Tables that overflow the block's list of live entries: every slot full
    at the presets' S = 12 and R = 5 (a halo of 756 pixels x 12 entries
    against 2,048 places), the widest stencil (R = 8, more than 48 KB of
    shared memory), more slot planes than one word of live bits holds
    (S = 40), and no neighbourhood at all (R = 0).  The planes then run in
    groups, in a fixed order."""
    cfg = tiny_test_config(image_width=w, image_height=h, phd_pixel_table_slots=S,
                           phd_neighbor_half=R)
    params = FilterParams(detection_probability=0.9, noise_number=0.1, if_consider_depth_noise=True,
                          max_forget_count=7)  # no entry without weight: the list is as full as can be
    t, c = _phd_inputs(cfg, cuda, seed=6, fill=0.5, front_fill=True, kind=kind)
    args = _pass_a_args(cfg, params, t, c)
    if kind == "full":
        assert bool((args[5] != 0).all())
    ck = _check_pass_a(args)
    assert (ck > 0).any()


#: Stencils and tables past the main instances: pass A lists one plane of
#: the halo up to R = 13 and sums at most 8,192 window entries a pixel, and
#: runs its wide instance (the halo in chunks, a partial a window row) past
#: either; pass B holds the halo and a tile's work list up to what the
#: card's 227 KB take (at R = 5, S = 431) and runs its wide instance (the
#: occupied entries in rounds, the halo in pieces past R = 23) above; both
#: wide instances work from the live planes a streaming pass finds first.
#: Pass A's first wide shapes close the list: S = 68 at R = 5 and R = 13 at
#: S = 12.  (S, R, h, w).
WIDE_STENCILS = [(4, 9, 40, 70), (4, 16, 40, 70), (4, 24, 37, 53), (512, 5, 19, 40),
                 (3, 60, 20, 70), (68, 5, 19, 40), (12, 13, 40, 70)]


@pytest.mark.gpu
@pytest.mark.parametrize("S,R,h,w", WIDE_STENCILS)
@pytest.mark.parametrize("kind", ["full", None])
def test_pass_a_kernel_wide_stencils(cuda, kind, S, R, h, w):
    """Pass A at R = 9, 16, 24 and 60 (a halo of many chunks, most outside
    the image) and at S = 512: within rtol 2e-5 of the plain stencils, a
    second launch with the first one's bits."""
    cfg = tiny_test_config(image_width=w, image_height=h, phd_pixel_table_slots=S,
                           phd_neighbor_half=R)
    params = FilterParams(detection_probability=0.9, noise_number=0.1, if_consider_depth_noise=True,
                          max_forget_count=7)
    t, c = _phd_inputs(cfg, cuda, seed=6, fill=0.3 if S > 100 else 0.5, front_fill=True, kind=kind)
    ck = _check_pass_a(_pass_a_args(cfg, params, t, c))
    assert (ck > 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("R", [5, 3])
@pytest.mark.parametrize("kind,independent",
                         [(kind, False) for kind in (*PHD_EDGE_TABLES, None)] + [(None, True)])
def test_pass_b_kernel_at_the_edges(cuda, kind, independent, R):
    """Pass B on an image that is no multiple of the tile (37 x 53), an odd
    slot count, and the tables its work list has to get right: every entry
    occupied (the list is full), none (nothing but zeros to write), one
    patch (most blocks idle), and an occupied entry with forgetting factor 0
    whose flag must be set.  acc at rtol 2e-5 / atol 1e-6, flags equal."""
    cfg = tiny_test_config(image_width=53, image_height=37, phd_pixel_table_slots=5,
                           phd_neighbor_half=R)
    params = FilterParams(detection_probability=0.9, noise_number=0.1,
                          if_use_independent_filter=independent, if_consider_depth_noise=True)
    t, c = _phd_inputs(cfg, cuda, seed=4, fill=0.3, front_fill=True, kind=kind)
    ck, args = _pass_b_args(cfg, params, t, c)
    acc_p, right_p = phd.pass_b_raw(*args)
    before = phd_cuda.pass_b_cuda.launches
    acc_k, right_k = phd_cuda.pass_b_cuda(*args)
    torch.cuda.synchronize()
    assert phd_cuda.pass_b_cuda.launches == before + 1
    torch.testing.assert_close(acc_k, acc_p, rtol=2e-5, atol=1e-6)
    assert right_k.dtype == torch.bool and torch.equal(right_k, right_p)
    occupied = t.meta >= 0
    assert not acc_k[~occupied].any() and not right_k[~occupied].any()
    if kind == "zero_ff":
        assert acc_k[ZERO_FF_ENTRY] == 0 and right_k[ZERO_FF_ENTRY]
    if kind == "full":
        assert occupied.all()
    nw_p, nf_p = phd.stencil_pass_b(cfg, params, t, c, ck)
    nw_k, nf_k = phd.stencil_pass_b_any(cfg, params, t, c, ck)
    torch.testing.assert_close(nw_k, nw_p, rtol=2e-5, atol=1e-6)
    assert torch.equal(nf_k, nf_p)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [5, 3])
def test_pass_b_kernel_tiny_terms_bit_equal(cuda, R):
    """Terms that underflow: particles up to 9.3 sigma per axis from a flat
    observation plane, inside the plain version's 9.9-sigma clip, so no term
    is dropped by either side, and a share of them is zero, denormal, or
    gives a denormal quotient.  The kernel divides such terms without the
    hardware's slow path and must give the division's bits: acc is compared
    bit for bit.  Some ck_kappa lie outside the range that shortcut takes
    (zero, negative, denormal, huge, infinite, NaN)."""
    cfg = tiny_test_config(image_width=53, image_height=37, phd_pixel_table_slots=5,
                           phd_neighbor_half=R)
    params = FilterParams(detection_probability=0.9, noise_number=0.1, if_consider_depth_noise=True)
    t, c = _phd_inputs(cfg, cuda, seed=8, fill=0.5, front_fill=True)
    g = torch.Generator(device=cuda)
    g.manual_seed(8)
    centre = torch.tensor([0.0, 0.0, 2.5], device=cuda)
    off = lambda: (torch.rand(t.px.shape, generator=g, device=cuda) * 2 - 1) * 2.8
    t = t._replace(px=off(), py=off(), pz=off() + 2.5)
    # the odd ck_kappa sit on valid pixels (an invalid pixel's is never read)
    odd_at = torch.arange(48, device=cuda) * (cfg.height * cfg.width // 64)
    valid = c.valid.clone()
    valid.view(-1)[odd_at] = True
    c = c._replace(pos=centre.expand(cfg.height, cfg.width, 3).contiguous(),
                   sigma=torch.full_like(c.sigma, 0.3), valid=valid)
    ck, args = _pass_b_args(cfg, params, t, c)
    for odd in (False, True):
        if odd:
            ck = ck.clone()
            special = torch.tensor([0.0, -1.0, 1e-40, 1e38, float("inf"), float("nan"), 1e-7, 3e6],
                                   device=cuda)
            ck.view(-1)[odd_at] = special.repeat(6)
            args = (*args[:-1], ck)
        acc_p, right_p = phd.pass_b_raw(*args)
        acc_k, right_k = phd_cuda.pass_b_cuda(*args)
        torch.cuda.synchronize()
        assert torch.equal(right_k, right_p)
        same = (acc_k.view(torch.int32) == acc_p.view(torch.int32)) | (acc_k.isnan() & acc_p.isnan())
        # an empty entry's sum is 0 in the kernel; the plain version divides its
        # masked zeros too, and 0 / 0 or 0 / NaN is NaN there (the caller drops both)
        same |= args[5] == -2
        assert bool(same.all()), f"{int((~same).sum())} sums differ in their bits (odd ck: {odd})"
        fin = acc_p[acc_p.isfinite()]
        assert (fin > 0).any() and ((fin > 0) & (fin < 1.1754944e-38)).any()


@pytest.mark.gpu
@pytest.mark.parametrize("S,R,h,w", [(40, 8, 37, 53), *WIDE_STENCILS])
@pytest.mark.parametrize("independent", [False, True])
def test_pass_b_kernel_large_shared_memory(cuda, independent, S, R, h, w):
    """Pass B where a block's halo and work list pass 48 KB of shared memory
    (R = 8 with 40 slots), and past what the main instance takes: R = 9, 16,
    24 and 60, and S = 512, which its wide instance runs.  acc within rtol
    2e-5 / atol 1e-6, flags equal; a second launch gives the same bits (each
    entry's terms in the plain version's order, whatever the staging)."""
    cfg = tiny_test_config(image_width=w, image_height=h, phd_pixel_table_slots=S,
                           phd_neighbor_half=R)
    params = FilterParams(detection_probability=0.9, noise_number=0.1,
                          if_use_independent_filter=independent, if_consider_depth_noise=True)
    t, c = _phd_inputs(cfg, cuda, seed=6, fill=0.1, front_fill=True)
    _, args = _pass_b_args(cfg, params, t, c)
    acc_p, right_p = phd.pass_b_raw(*args)
    before = phd_cuda.pass_b_cuda.launches
    acc_k, right_k = phd_cuda.pass_b_cuda(*args)
    torch.cuda.synchronize()
    assert phd_cuda.pass_b_cuda.launches == before + 1
    torch.testing.assert_close(acc_k, acc_p, rtol=2e-5, atol=1e-6)
    assert torch.equal(right_k, right_p)
    assert independent or right_k.any()
    again, _ = phd_cuda.pass_b_cuda(*args)
    assert torch.equal(again.view(torch.int32), acc_k.view(torch.int32))


@pytest.mark.gpu
def test_pass_b_wide_instance_has_the_main_instances_bits(cuda):
    """At S = 431 and R = 5 the main instance of pass B still fits (232,432
    bytes of shared memory); one slot plane more goes to the wide instance.
    Both give every entry the same bits: the planes the two tables share
    are compared bit for bit."""
    base = dict(image_width=1242 // 6, image_height=375 // 6, phd_neighbor_half=5)
    params = FilterParams(detection_probability=0.9, noise_number=0.1, if_consider_depth_noise=True)
    cfg = tiny_test_config(phd_pixel_table_slots=432, **base)
    t, c = _phd_inputs(cfg, cuda, seed=3, fill=0.02, front_fill=True)
    _, args = _pass_b_args(cfg, params, t, c)
    acc_wide, right_wide = phd_cuda.pass_b_cuda(*args)
    cut = tiny_test_config(phd_pixel_table_slots=431, **base)
    sub = [a[:431].contiguous() if isinstance(a, torch.Tensor) and a.dim() == 3 else a
           for a in (cut, *args[1:])]
    acc_main, right_main = phd_cuda.pass_b_cuda(*sub)
    torch.cuda.synchronize()
    assert torch.equal(acc_wide[:431].view(torch.int32), acc_main.view(torch.int32))
    assert torch.equal(right_wide[:431], right_main) and right_main.any()


@pytest.mark.gpu
@pytest.mark.parametrize("main,wide,h,w", [((67, 5), (68, 5), 19, 40), ((12, 12), (12, 13), 40, 70)])
@pytest.mark.parametrize("kind", ["full", None])
def test_pass_a_first_wide_shapes_beside_their_main_neighbours(cuda, kind, main, wide, h, w):
    """Pass A's switch points: (S, R) = (67, 5) and (12, 12) run the main
    instance (8,107 and 7,500 window entries a pixel), one plane or one R more
    the wide one (its live-plane pass launched once).  Both within rtol 2e-5
    / atol 1e-6 of the plain stencil, each with a second launch's bits."""
    params = FilterParams(detection_probability=0.9, noise_number=0.1, if_consider_depth_noise=True,
                          max_forget_count=7)
    for (S, R), is_wide in ((main, False), (wide, True)):
        cfg = tiny_test_config(image_width=w, image_height=h, phd_pixel_table_slots=S,
                               phd_neighbor_half=R)
        t, c = _phd_inputs(cfg, cuda, seed=6, fill=0.3, front_fill=True, kind=kind)
        before = phd_cuda.live_weights_cuda.launches
        ck = _check_pass_a(_pass_a_args(cfg, params, t, c))
        assert phd_cuda.live_weights_cuda.launches - before == (2 if is_wide else 0), (S, R)
        assert (ck > 0).any()


def _empty_groups_table(cfg, device, live_groups):
    """A table of S = cfg's slots whose plane groups of 32 outside
    ``live_groups`` are empty, every entry of those inside random."""
    t, c = _phd_inputs(cfg, device, seed=9, fill=0.15)
    S = cfg.phd_pixel_table_slots
    keep = torch.zeros(S, dtype=torch.bool, device=device)
    for g in live_groups:
        keep[32 * g: 32 * g + 32] = True
    return t._replace(meta=torch.where(keep[:, None, None], t.meta, -1)), c, keep


@pytest.mark.gpu
@pytest.mark.parametrize("independent", [False, True])
def test_wide_instances_skip_empty_plane_groups(cuda, independent):
    """S = 512 where only the plane groups 0, 3, 7 and 15 hold entries: the
    live-plane passes find exactly those (against ``ops.phd.live_planes``),
    pass A wide is within rtol 2e-5 of the plain stencil, and pass B wide
    gives every entry of the live groups the bits the main instance gives it
    on a table of those 128 planes alone (an entry's sum is its own),
    zeros elsewhere, and the plain version's flags."""
    live_groups = (0, 3, 7, 15)
    base = dict(image_width=53, image_height=37, phd_neighbor_half=5)
    cfg = tiny_test_config(phd_pixel_table_slots=512, **base)
    params = FilterParams(detection_probability=0.9, noise_number=0.1,
                          if_use_independent_filter=independent, if_consider_depth_noise=True)
    t, c, keep = _empty_groups_table(cfg, cuda, live_groups)
    a_args = _pass_a_args(cfg, params, t, c)
    weff = a_args[5]
    assert torch.equal(phd_cuda.live_weights_cuda(weff), phd.live_planes(weff != 0))
    words = phd.live_planes(weff != 0)
    assert [g for g in range(16) if words[g].any()] == list(live_groups)
    _check_pass_a(a_args)
    _, b_args = _pass_b_args(cfg, params, t, c)
    acc, right = phd_cuda.pass_b_cuda(*b_args)
    acc_p, right_p = phd.pass_b_raw(*b_args)
    torch.testing.assert_close(acc, acc_p, rtol=2e-5, atol=1e-6)
    assert torch.equal(right, right_p)
    assert not acc[~keep].any() and not right[~keep].any()
    cut = tiny_test_config(phd_pixel_table_slots=int(keep.sum()), **base)
    sub = [a[keep].contiguous() if isinstance(a, torch.Tensor) and a.dim() == 3 else a
           for a in (cut, *b_args[1:])]
    acc_main, right_main = phd_cuda.pass_b_cuda(*sub)
    torch.cuda.synchronize()
    assert torch.equal(acc[keep].view(torch.int32), acc_main.view(torch.int32))
    assert torch.equal(right[keep], right_main)


def _off_bounds(t, off):
    """``t``'s values in a tensor that starts ``off`` elements past an
    allocation's start (a contiguous view off 16-byte bounds for off > 0)."""
    flat = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = flat[off:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("S,h,w", [(1, 9, 33), (31, 19, 40), (32, 8, 7), (33, 37, 53),
                                   (70, 5, 129)])
@pytest.mark.parametrize("off", [0, 1, 2])
def test_live_plane_kernels_match_plain(cuda, S, h, w, off):
    """The live-plane passes against ``ops.phd.live_planes`` at plane counts
    on both sides of a word, tables whose entries are no multiple of a
    vector, and tensors on and off 16-byte bounds: w_eff's zeros (-0.0
    among them) are empty, NaN is live; trk_eff's -2 is empty, and there acc
    and right are zeroed while the occupied entries keep what they held."""
    g = torch.Generator(device=cuda)
    g.manual_seed(S)
    u = torch.rand((S, h, w), generator=g, device=cuda)
    weff = torch.where(u < 0.5, 0.0, u)
    weff = torch.where(u < 0.1, -0.0, weff)
    weff = _off_bounds(torch.where(u > 0.97, float("nan"), weff), off)
    live = phd_cuda.live_weights_cuda(weff)
    assert live.dtype == torch.int32 and live.shape == (-(-S // 32), h, w)
    assert torch.equal(live, phd.live_planes(weff != 0))
    trk = _off_bounds(torch.where(u < 0.6, -2, (u * 100).int()), off)
    acc = _off_bounds(torch.full((S, h, w), 7.0, device=cuda), 2 - off)
    right = _off_bounds(torch.ones((S, h, w), dtype=torch.bool, device=cuda), off)
    before = phd_cuda.live_tracks_cuda.launches
    live = phd_cuda.live_tracks_cuda(trk, acc, right)
    torch.cuda.synchronize()
    assert phd_cuda.live_tracks_cuda.launches == before + 1
    occupied = trk != -2
    assert torch.equal(live, phd.live_planes(occupied))
    assert torch.equal(acc, torch.where(occupied, 7.0, 0.0)) and torch.equal(right, occupied)


def _ptxas_functions(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes)} from nvcc's
    -Xptxas -v output."""
    import re

    out, current, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current is not None:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            out[current] = (int(m.group(1)), spill)
            current = None
    return out


@pytest.mark.gpu
def test_wide_instances_fit_their_launch_bounds(cuda):
    """ptxas fits pass A wide and pass B wide's one-piece instance in 64
    registers (4 blocks of 256 threads an SM), the many-piece instance in
    128, with no spill, and the live-plane passes spill nothing."""
    from semantic_dsp_map_tpu_torch.ops import cuda_lib

    _, _, log = cuda_lib.build()
    found = _ptxas_functions(log)
    limits = {"18pass_a_wide_kernel": 64, "18pass_b_wide_kernelILb1E": 64,
              "18pass_b_wide_kernelILb0E": 128, "18live_planes_kernelILb0E": 255,
              "18live_planes_kernelILb1E": 255}
    for key, limit in limits.items():
        hits = [v for name, v in found.items() if key in name]
        assert len(hits) == 1, (key, sorted(found))
        regs, spill = hits[0]
        assert regs <= limit and spill == 0, (key, regs, spill)


@pytest.mark.gpu
def test_generic_instances_spill_nothing(cuda):
    """ptxas fits the render's generic instance in the 64 registers of its
    launch bounds (four blocks of 256 threads an SM) and the merge's two
    generic instances in theirs, with no spill."""
    from semantic_dsp_map_tpu_torch.ops import cuda_lib

    _, _, log = cuda_lib.build()
    found = _ptxas_functions(log)
    limits = {"21render_generic_kernel": 64, "20merge_generic_kernelILb0E": 255,
              "20merge_generic_kernelILb1E": 255}
    for key, limit in limits.items():
        hits = [v for name, v in found.items() if key in name]
        assert len(hits) == 1, (key, sorted(found))
        regs, spill = hits[0]
        assert regs <= limit and spill == 0, (key, regs, spill)


def _render_state(cfg, device, seed):
    """Random particles, stamps and scroll stamps (the generator of
    tests/test_render_pallas.py)."""
    rng = np.random.RandomState(seed)
    V, K = cfg.num_voxels, cfg.slots_per_voxel
    s = init_map_state(cfg, device=device)
    T = lambda a: torch.from_numpy(a).to(device)
    weight = (rng.rand(V * K) * 1.4).astype(np.float32)
    weight[: V * K // 8] *= 0.05  # hit the GC path
    p = dataclasses.replace(
        s.particles,
        status=T(rng.choice([0, 1, 2, 3], size=V * K, p=[0.3, 0.4, 0.2, 0.1]).astype(np.uint8)),
        weight=T(weight),
        track=T(rng.randint(0, 4, V * K).astype(np.int32)),
        label=T(rng.randint(0, 8, V * K).astype(np.uint8)),
        stamp=T(rng.randint(0, 3, V * K).astype(np.int32)),
    )
    scroll = dataclasses.replace(
        s.scroll,
        axis_stamp_x=T(rng.randint(0, 2, cfg.nx).astype(np.int32)),
        axis_stamp_y=T(rng.randint(0, 2, cfg.ny).astype(np.int32)),
    )
    return dataclasses.replace(
        s, particles=p, scroll=scroll, voxel_stamp=T(rng.randint(0, 3, V).astype(np.int32))
    )


@pytest.mark.gpu
@pytest.mark.parametrize("slots_n", [2, 3])  # K = 3 (ZED2, tiny) and K = 7 (VKITTI2)
@pytest.mark.parametrize("seed", [5, 17])
def test_render_kernel_matches_plain(cuda, seed, slots_n):
    cfg = tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    s = _render_state(cfg, cuda, seed)
    vax = codecs.axis_stamps_per_voxel(cfg, s.scroll)
    new, want = render_core_plain(cfg, s.particles, s.voxel_stamp, vax, 0.4)
    before = render_core_cuda.launches
    p, got = render_core_cuda(cfg, s.particles, s.voxel_stamp, vax, 0.4)
    assert render_core_cuda.launches == before + 1
    for name in ("occ", "label", "track", "weight_sum"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(p.weight, new.weight) and torch.equal(p.status, new.status)


def _render_edge_store(V, K, device, seed, kind):
    from semantic_dsp_map_tpu_torch.state import Particles

    d = (render_generic_store if kind in RENDER_GENERIC_EDGES else render_store)(V, K, seed, kind)
    T = lambda a: torch.from_numpy(a).to(device)
    n = V * K
    zeros = torch.zeros(n, device=device)
    p = Particles(px=zeros, py=zeros, pz=zeros, weight=T(d["weight"]), label=T(d["label"]),
                  track=T(d["track"]), status=T(d["status"]),
                  forget=torch.zeros(n, dtype=torch.uint8, device=device), stamp=T(d["stamp"]))
    return p, T(d["voxel_stamp"]), T(d["vax"])


@pytest.mark.gpu
@pytest.mark.parametrize("V", [1, 1023, 4099, 3 * 1024 + 1])
@pytest.mark.parametrize("slots_n", [1, 2, 3, 4, 5, 6, 7, 8, 10])  # K = 1 ... 31, 63 ... 1023
@pytest.mark.parametrize("kind", STORE_EDGES)
def test_render_kernel_at_the_edges(cuda, kind, slots_n, V):
    """The render with every K it is built for, voxel counts that are no
    multiple of a block's span or its sub-spans, slot counts that are no
    multiple of the 4 and 16 slots a thread loads, stale voxel stamps, and
    stores with every slot dead (every span ends after its status bytes),
    every slot alive, and all but one stretch empty.  occ, label, track and
    the new status equal; the sums are bit-equal too (slot order is the plain
    version's)."""
    cfg = tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    K = cfg.slots_per_voxel
    p, vst, vax = _render_edge_store(V, K, cuda, seed=V + slots_n, kind=kind)
    new, want = render_core_plain(cfg, p, vst, vax, 0.4)
    pk = dataclasses.replace(p, weight=p.weight.clone(), status=p.status.clone())
    before = render_core_cuda.launches
    pk, got = render_core_cuda(cfg, pk, vst, vax, 0.4)
    torch.cuda.synchronize()
    assert render_core_cuda.launches == before + 1
    for name in ("occ", "label", "track"):
        g = getattr(got, name)
        assert g.shape == (V,) and g.dtype == torch.int32 and torch.equal(g, getattr(want, name)), name
    assert torch.equal(pk.status, new.status)
    assert torch.equal(got.weight_sum.view(torch.int32), want.weight_sum.view(torch.int32))
    assert torch.equal(pk.weight.view(torch.int32), new.weight.view(torch.int32))
    if kind == "all_dead":
        assert not (want.occ > 0).any() and torch.equal(pk.weight, p.weight)
    elif V > 1000:
        assert (want.occ == 1).any() and (want.occ == -1).any()
    if kind in ("mixed", "all_alive") and V > 1000:
        assert (new.weight != p.weight).any()
    # a second render of the rendered store changes nothing more
    again, _ = render_core_cuda(cfg, dataclasses.replace(pk, weight=pk.weight.clone(),
                                                         status=pk.status.clone()), vst, vax, 0.4)
    assert torch.equal(again.weight, pk.weight) and torch.equal(again.status, pk.status)


@pytest.mark.gpu
@pytest.mark.parametrize("V", [1, 256, 257, 1029])
@pytest.mark.parametrize("slots_n", [6, 7, 8, 10])  # K = 63, 127, 255, 1023
@pytest.mark.parametrize("kind", RENDER_GENERIC_EDGES)
def test_render_generic_kernel_at_its_edges(cuda, kind, slots_n, V):
    """The generic render (K past 31: a block streams a span of 256 voxels,
    its warps share the valid voxels with a status) on the stores its
    design has to get right: one voxel with a status a span, at its first
    and at its last voxel; every voxel of a span valid and every slot
    alive (at K = 255 and 1023 more contributing slots than a warp's buffer
    holds: rounds); alive slots of weight -0.0, +0.0 and NaN; same-track
    sums tied across two tracks; voxel counts that are no multiple of the
    span.  occ, label, track and the new status equal, weight_sum's bits
    and the new weights' bits equal (NaN for NaN: the plain clamp is
    torch.minimum, which picks a NaN's bits of its own, where the kernel
    leaves a NaN weight as it is)."""
    cfg = tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    K = cfg.slots_per_voxel
    p, vst, vax = _render_edge_store(V, K, cuda, seed=V + slots_n, kind=kind)
    new, want = render_core_plain(cfg, p, vst, vax, 0.4)
    pk = dataclasses.replace(p, weight=p.weight.clone(), status=p.status.clone())
    before = render_core_cuda.launches
    pk, got = render_core_cuda(cfg, pk, vst, vax, 0.4)
    torch.cuda.synchronize()
    assert render_core_cuda.launches == before + 1
    for name in ("occ", "label", "track"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(pk.status, new.status)
    assert torch.equal(got.weight_sum.view(torch.int32), want.weight_sum.view(torch.int32))
    nan = torch.isnan(new.weight)
    assert torch.equal(torch.isnan(pk.weight), nan)
    assert torch.equal(pk.weight[~nan].view(torch.int32), new.weight[~nan].view(torch.int32))
    if V > 256:
        assert (want.occ == 1).any()
    if kind == "span_all_live":
        assert (want.occ >= 0).all()


@pytest.mark.gpu
def test_render_kernel_refuses_a_misaligned_store(cuda):
    """The render loads 16 bytes a thread: a store that starts off a 16-byte
    boundary raises, it is not read askew."""
    cfg = tiny_test_config()
    K, V = cfg.slots_per_voxel, 64
    p, vst, vax = _render_edge_store(V + 1, K, cuda, seed=1, kind="mixed")
    off = dataclasses.replace(p, **{f: getattr(p, f)[K:] for f in
                                    ("weight", "stamp", "status", "track", "label")})
    assert off.weight.is_contiguous() and off.status.data_ptr() % 16 != 0
    with pytest.raises(RuntimeError):
        render_core_cuda(cfg, off, vst[1:], vax[1:], 0.4)


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["virtual_kitti2_config", "zed2_config"])
def test_labeled_cloud_cuda_has_the_cpu_bits(cuda, preset):
    """The back-projection multiplies by a float32 reciprocal held on the
    cloud's device: the same bits on both devices (a division by a Python
    scalar is a multiplication by its reciprocal on CUDA only)."""
    import semantic_dsp_map_tpu_torch as T
    from semantic_dsp_map_tpu_torch.ops.projection import generate_labeled_cloud

    cfg = getattr(T, preset)()
    rng = np.random.RandomState(2)
    H, W = cfg.height, cfg.width
    args = (torch.from_numpy((rng.rand(H, W) * 30 + 0.3).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 5, (H, W)).astype(np.int32)),
            torch.arange(65536, dtype=torch.int32) % 10, torch.eye(3), torch.zeros(3))
    params = FilterParams(if_consider_depth_noise=True)
    want = generate_labeled_cloud(cfg, params, *args, 65523)
    got = generate_labeled_cloud(cfg, params, *(a.to(cuda) for a in args), 65523)
    # x and y of the camera frame (identity pose): the products that decide pixels
    assert torch.equal(got.pos.cpu().view(torch.int32), want.pos.view(torch.int32))
    assert torch.equal(got.valid.cpu(), want.valid)


@pytest.mark.gpu
@pytest.mark.parametrize("slots_n", [2, 3])
@pytest.mark.parametrize("quat", [[1.0, 0, 0, 0], [0.9622502, 0.0544331, 0.2613872, 0.0555144]])
def test_observe_kernels_match_plain(cuda, quat, slots_n):
    """Both observe kernels byte for byte against their plain scans, on a
    seeded store with mixed status, stamps and tracks and a scrolled map."""
    cfg = tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    s = _render_state(cfg, cuda, seed=9)
    rng = np.random.RandomState(9)
    n = cfg.num_voxels * cfg.slots_per_voxel
    T = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    px, py, pz = T(rng.randn(n) * 2), T(rng.randn(n) * 2), T(rng.rand(n) * 10 - 1)
    p = s.particles
    vax = codecs.axis_stamps_per_voxel(cfg, s.scroll)
    _, _, r_cw, t_cw = camera_matrices(torch.tensor([0.4, -0.2, 0.7], device=cuda),
                                       torch.tensor(quat, device=cuda))
    args = (cfg, px, py, pz, p.status, p.stamp, vax, r_cw, t_cw)
    want = front_candidates_plain(*args)
    before = front_candidates_cuda.launches
    got = front_candidates_cuda(*args)
    assert front_candidates_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and torch.equal(g, w)
    assert 0 < int(want[1].sum()) < int(want[0].sum())

    max_movable = 2
    args = (cfg, p.track, p.status, p.stamp, vax, max_movable)
    want = movable_voxels_plain(*args)
    before = movable_voxels_cuda.launches
    got = movable_voxels_cuda(*args)
    assert movable_voxels_cuda.launches == before + 1
    assert torch.equal(got, want) and 0 < int(want.sum()) < cfg.num_voxels


@pytest.mark.gpu
@pytest.mark.parametrize("V", [1, 1023, 4099, 3 * 1024 + 1])
@pytest.mark.parametrize("slots_n", [1, 2, 3, 4, 5, 6, 7, 8, 10])  # K = 1 ... 31, 63 ... 1023
@pytest.mark.parametrize("kind", STORE_EDGES)
def test_front_kernel_at_the_edges(cuda, kind, slots_n, V):
    """The candidate scan with every K it is built for, voxel counts that
    are no multiple of a block's span (1024) or of the four voxels a thread
    writes, slot counts that are no multiple of the four slots a thread
    loads, and stores with every slot dead, every slot alive and all but one
    stretch of slots empty (whole spans then end early); bytes equal."""
    cfg = tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    K = cfg.slots_per_voxel
    d = particle_store(V * K, (V, 1, 1), seed=V + slots_n, max_movable=2, kind=kind)
    T = lambda a: torch.from_numpy(a).to(cuda)
    _, _, r_cw, t_cw = camera_matrices(
        torch.tensor([0.4, -0.2, 0.7], device=cuda),
        torch.tensor([0.9622502, 0.0544331, 0.2613872, 0.0555144], device=cuda))
    args = (cfg, T(d["px"]), T(d["py"]), T(d["pz"]), T(d["status"]), T(d["stamp"]),
            T(d["axis"][0]), r_cw, t_cw)
    want = front_candidates_plain(*args)
    before = front_candidates_cuda.launches
    got = front_candidates_cuda(*args)
    torch.cuda.synchronize()
    assert front_candidates_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == (V,) and g.dtype == torch.uint8 and torch.equal(g, w)
    if kind == "all_dead":
        assert not want[0].any()
    elif kind == "all_alive":
        assert want[0].all()
    elif kind == "sparse" and V > 1000:
        assert 0 < int(want[0].sum()) < V // 20
    if V > 1000 and kind in ("mixed", "all_alive"):
        # 31 live slots a voxel put a candidate in every voxel of these stores
        assert (0 < int(want[1].sum()) < V or (K == 31 and kind == "all_alive" and want[1].all())
                or (K > 31 and want[1].any()))


@pytest.mark.gpu
@pytest.mark.parametrize("V", [1, 1023, 4099, 3 * 1024 + 1])
@pytest.mark.parametrize("slots_n", [1, 2, 3, 4, 5, 6, 7, 8, 10])  # K = 1 ... 31, 63 ... 1023
@pytest.mark.parametrize("kind", STORE_EDGES)
def test_movable_kernel_at_the_edges(cuda, kind, slots_n, V):
    """The movable scan with every K it is built for, voxel counts that are
    no multiple of a block's span (1024) or of the four voxels a thread
    writes, slot counts that are no multiple of the 16 status bytes a
    thread loads, and stores with every slot dead (every span ends after its
    status), every slot alive and all but one stretch of slots empty; bytes
    equal, in a CUDA graph too."""
    cfg = tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    K = cfg.slots_per_voxel
    d = particle_store(V * K, (V, 1, 1), seed=V + slots_n, max_movable=2, kind=kind)
    T = lambda a: torch.from_numpy(a).to(cuda)
    args = (cfg, T(d["track"]), T(d["status"]), T(d["stamp"]), T(d["axis"][0]), 2)
    want = movable_voxels_plain(*args)
    before = movable_voxels_cuda.launches
    got = movable_voxels_cuda(*args)
    torch.cuda.synchronize()
    assert movable_voxels_cuda.launches == before + 1
    assert got.shape == (V,) and got.dtype == torch.uint8 and torch.equal(got, want)
    if kind == "all_dead":
        assert not want.any()
    elif V > 1000:
        # 31 live slots a voxel hold a movable track in nearly every voxel
        assert 0 < int(want.sum()) < V or (K == 31 and kind == "all_alive" and want.all()) or (
            K > 31 and want.any())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = movable_voxels_cuda(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, want)


@pytest.mark.gpu
def test_movable_kernel_refuses_a_misaligned_store(cuda):
    """The movable scan loads 16 bytes a thread: a store that starts off a
    16-byte boundary raises, it is not read askew."""
    cfg = tiny_test_config()
    K, V = cfg.slots_per_voxel, 64
    d = particle_store(V * K + 1, (V, 1, 1), seed=1, max_movable=2)
    T = lambda a: torch.from_numpy(a).to(cuda)
    status = T(d["status"])[1:]
    assert status.is_contiguous() and status.data_ptr() % 16 != 0
    with pytest.raises(RuntimeError):
        movable_voxels_cuda(cfg, T(d["track"])[1:], status, T(d["stamp"])[1:], T(d["axis"][0]), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("slots_n", [6, 7])  # K = 63, 127
def test_a_wide_store_runs_on_the_card(cuda, slots_n):
    """K = 63 and 127 (max_particle_num_per_voxel_n = 6, 7) on the card:
    the map runs the tiny dynamic scene through every kernel (each per-voxel
    kernel once a frame, birth's merge twice), and on its store the four
    per-voxel kernels give their plain versions' bytes."""
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import merge_blocks_cuda
    from torch_parity import dynamic_scene

    cfg = tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    params = FilterParams(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                          depth_noise_model_zero_order=0.2, prediction_stddev=0.0)
    dsp = SemanticDSPMap(cfg, params, device=cuda)
    fns = (render_core_cuda, front_candidates_cuda, movable_voxels_cuda, merge_blocks_cuda)
    before = [kernel_runs(fn) for fn in fns]
    frames = 4
    for t in range(frames):
        res, diag = dsp.update(*dynamic_scene(cfg, t, MaskKpts))
    assert int(diag.born_count) > 0 and bool((res.occ == 1).any())
    assert [kernel_runs(fn) - b for fn, b in zip(fns, before)] == [frames] * 3 + [2 * frames]
    s = dsp.state
    p = s.particles
    vax = codecs.axis_stamps_per_voxel(cfg, s.scroll)
    assert int((p.status.view(-1, cfg.slots_per_voxel) != 0).sum(1).max()) > 1
    new, want = render_core_plain(cfg, p, s.voxel_stamp, vax, 0.4)
    pk = dataclasses.replace(p, weight=p.weight.clone(), status=p.status.clone())
    pk, got = render_core_cuda(cfg, pk, s.voxel_stamp, vax, 0.4)
    for name in ("occ", "label", "track", "weight_sum"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(pk.status, new.status) and torch.equal(pk.weight, new.weight)
    r_cw, t_cw = torch.eye(3, device=cuda), torch.zeros(3, device=cuda)
    fargs = (cfg, p.px, p.py, p.pz, p.status, p.stamp, vax, r_cw, t_cw)
    for g, w in zip(front_candidates_cuda(*fargs), front_candidates_plain(*fargs)):
        assert torch.equal(g, w)
    margs = (cfg, p.track, p.status, p.stamp, vax, dsp.registry.max_movable_instance_id)
    assert torch.equal(movable_voxels_cuda(*margs), movable_voxels_plain(*margs))


#: ptxas's registers and static shared memory of the main instances (K <= 31
#: and the PHD passes' main kernels), as ptxas printed them on an H100
#: (nvcc -O3 -fmad=false, sm_90a) before the generic and wide instances were
#: added beside them: these must not move.
MAIN_INSTANCES = {
    "pass_a_kernel": (56, 32), "pass_b_kernel": (40, 16),
    **{f"render_kernel<{k}>": v for k, v in
       {31: (128, 15880), 15: (128, 7688), 7: (80, 7184), 3: (45, 3088), 1: (48, 1040)}.items()},
    **{f"front_kernel<{k}>": v for k, v in
       {31: (78, 35840), 15: (64, 19456), 7: (62, 11264), 3: (48, 7168), 1: (47, 5120)}.items()},
    **{f"movable_kernel<{k}>": v for k, v in
       {31: (255, 31744), 15: (178, 15360), 7: (80, 7168), 3: (48, 3072), 1: (48, 1024)}.items()},
    **{f"merge_kernel<{k},true>": v for k, v in
       {31: (222, 26308), 15: (128, 25988), 7: (80, 12676), 3: (48, 6020), 1: (32, 10756)}.items()},
    **{f"merge_kernel<{k},false>": v for k, v in
       {31: (220, 26308), 15: (128, 25988), 7: (80, 12676), 3: (40, 6020), 1: (30, 10756)}.items()},
}


def ptxas_instances(log: str) -> dict:
    """{kernel<template arguments>: (registers, static shared bytes)} of the
    main instances in nvcc's -Xptxas -v output."""
    import re

    main = r"(13pass_a_kernel|13pass_b_kernel|13render_kernel|12front_kernel|14movable_kernel" \
        r"|12merge_kernel)(I(?:L[ib]\d+E)+E)?"
    out, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(main, line)
            current = None
            if m:
                args = re.findall(r"L([ib])(\d+)E", m.group(2) or "")
                text = ",".join(v if t == "i" else ("true" if v == "1" else "false")
                                for t, v in args)
                current = m.group(1).lstrip("0123456789") + (f"<{text}>" if text else "")
            continue
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and current is not None:
            out[current] = (int(m.group(1)), int(m.group(2) or 0))
            current = None
    return out


@pytest.mark.gpu
def test_main_instances_keep_their_registers_and_shared_memory(cuda):
    """The K <= 31 instances and the PHD passes' main kernels have the
    registers and shared memory ptxas gave them before the generic and wide
    instances were added (MAIN_INSTANCES): those sit beside them and change
    none of their code."""
    from semantic_dsp_map_tpu_torch.ops import cuda_lib

    _, _, log = cuda_lib.build()
    assert ptxas_instances(log) == MAIN_INSTANCES


@pytest.mark.gpu
def test_front_kernel_refuses_a_misaligned_store(cuda):
    """The scan loads 16 bytes a thread: a store that starts off a 16-byte
    boundary raises, it is not read askew."""
    cfg = tiny_test_config()
    K, V = cfg.slots_per_voxel, 64
    d = particle_store(V * K + 1, (V, 1, 1), seed=1, max_movable=2)
    T = lambda a: torch.from_numpy(a).to(cuda)
    _, _, r_cw, t_cw = camera_matrices(torch.zeros(3, device=cuda),
                                       torch.tensor([1.0, 0, 0, 0], device=cuda))
    px = T(d["px"])[1:]
    assert px.is_contiguous() and px.data_ptr() % 16 != 0
    with pytest.raises(RuntimeError):
        front_candidates_cuda(cfg, px, T(d["py"])[1:], T(d["pz"])[1:], T(d["status"])[1:],
                              T(d["stamp"])[1:], T(d["axis"][0]), r_cw, t_cw)


@pytest.mark.gpu
@pytest.mark.parametrize("independent", [False, True])
def test_zed2_scene_cuda_matches_cpu(cuda, independent):
    """The tiny ZED2 (bbox3d) scene through the default config, every kernel
    on, against the same map on the CPU: counters and renders equal."""
    params = FilterParams(
        if_consider_depth_noise=True, nb_ptc_num_per_point=1,
        depth_noise_model_zero_order=0.2, prediction_stddev=0.0,
        if_use_independent_filter=independent,
        bayesian_movement_distance_threshold=0.2, bayesian_movement_increment=0.4,
        bayesian_movement_decrement=0.05, bayesian_movement_probability_threshold=0.3,
    )
    cfg = tiny_test_config(keypoint_mode=KEYPOINTS_BBOX3D)
    cpu = SemanticDSPMap(cfg, params, device="cpu")
    gpu = SemanticDSPMap(cfg, params, device=cuda)
    launches = kernel_runs(front_candidates_cuda)
    moved = 0
    for t in range(10):
        rc, dc = cpu.update(*zed2_scene(cfg, t, MaskKpts))
        rg, dg = gpu.update(*zed2_scene(cfg, t, MaskKpts))
        assert {k: int(v) for k, v in dg._asdict().items()} == {
            k: int(v) for k, v in dc._asdict().items()
        }, f"frame {t}"
        for name in ("occ", "label", "track"):
            assert torch.equal(getattr(rg, name).cpu(), getattr(rc, name)), f"{name} frame {t}"
        torch.testing.assert_close(rg.weight_sum.cpu(), rc.weight_sum, rtol=2e-4, atol=1e-6)
        moved += int(dg.moved_count)
    assert moved > 0
    # frame 0 eager, frame 1 captured into a graph and replayed, then replays
    assert kernel_runs(front_candidates_cuda) == launches + 10


def _box_cloud(rng, n, size, center):
    """Points on the faces of a box, jittered off cell boundaries (the
    generator of tests/test_templates.py)."""
    pts = (rng.rand(n, 3) - 0.5) * size
    axis = rng.randint(0, 3, n)
    pts[np.arange(n), axis] = (rng.randint(0, 2, n) * 2 - 1) * size[axis] / 2
    return (pts + rng.randn(n, 3) * 0.004 + center).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("use_fs", [False, True])
def test_template_sweep_cuda_matches_cpu(cuda, use_fs):
    """The template sweep at the default match grid on the card gives the
    CPU's cells bit for bit: equal scores, transforms and aligned clouds."""
    from semantic_dsp_map_tpu_torch.ops.templates import (
        MatchGridConfig, center_cloud, template_match_bank,
    )

    rng = np.random.RandomState(3)
    size = np.array([4.31, 1.52, 1.73])
    g = MatchGridConfig()
    src = np.zeros((g.max_source_points, 3), np.float32)
    src[:3000] = _box_cloud(rng, 3000, size, np.array([1.03, 0.47, 9.11]))
    tpls = np.zeros((2, g.max_template_points, 3), np.float32)
    tpls[0, :1500] = center_cloud(_box_cloud(rng, 1500, size, np.zeros(3)))
    tpls[1, :1500] = center_cloud(_box_cloud(rng, 1500, size * 0.6, np.zeros(3)))
    sv = np.arange(g.max_source_points) < 3000
    tv = np.broadcast_to(np.arange(g.max_template_points) < 1500, (2, g.max_template_points))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (src, sv, np.array([0.2, -0.1, 0.0], np.float32), tpls, tv)]
    want = template_match_bank(g, use_fs, *args)
    got = template_match_bank(g, use_fs, *(a.to(cuda) for a in args))
    for w, gt in zip(want, got):
        assert torch.equal(gt.cpu(), w)
    assert int(want[0]) == 0 and float(want[1]) > 0.3


@pytest.mark.gpu
def test_smoothed_render_cuda_matches_cpu(cuda):
    """The neighbour-smoothed render (plain PyTorch) gives the same bytes on
    the card as on the CPU."""
    from semantic_dsp_map_tpu_torch.ops.render import render_occupancy_smoothed

    cfg = tiny_test_config(max_particle_num_per_voxel_n=3)
    want_p, want = render_occupancy_smoothed(cfg, _render_state(cfg, "cpu", seed=2), 0.3)
    gstate = _render_state(cfg, cuda, seed=2)
    got_p, got = render_occupancy_smoothed(cfg, gstate, 0.3)
    for name in ("occ", "label", "track", "weight_sum"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    assert torch.equal(got_p.status.cpu(), want_p.status)
    assert torch.equal(got_p.weight.cpu(), want_p.weight)
    assert (want.occ == 1).any() and (want.occ == -1).any()


@pytest.mark.gpu
@pytest.mark.parametrize("h, w, n", [(384, 1248, 1 << 22), (37, 53, 100_003)])
def test_gather_kernel_matches_plain(cuda, h, w, n):
    """The gather probe kernel against its plain version, byte for byte, at
    the probe's shape and at an odd one (a length that is no multiple of the
    block, a table that is no multiple of anything)."""
    from semantic_dsp_map_tpu_torch.benchmarks.prim_bench7 import make_inputs
    from semantic_dsp_map_tpu_torch.ops.probes import gather_plain
    from semantic_dsp_map_tpu_torch.ops.probes_cuda import gather_cuda

    depth, rc = make_inputs(cuda, h, w, n)
    before = gather_cuda.launches
    got = gather_cuda(depth, rc)
    torch.cuda.synchronize()
    assert gather_cuda.launches == before + 1
    assert got.shape == (n,) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), gather_plain(depth, rc).view(torch.int32))
    # the first and the last table entry are reachable
    ends = torch.tensor([0, h * w - 1], dtype=torch.int32, device=cuda)
    assert torch.equal(gather_cuda(depth, ends), depth.reshape(-1)[[0, -1]])
    with pytest.raises(ValueError):
        gather_cuda(depth, rc.long())
    with pytest.raises(ValueError):
        gather_cuda(depth.t(), rc)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 128), (58_720_256,), (1001,)])
def test_scale2_kernel_matches_plain(cuda, shape):
    """The x2 probe kernel against its plain version, byte for byte, at the
    probe's shape, at the size of the VKITTI2 particle store and at an odd
    length."""
    from semantic_dsp_map_tpu_torch.ops.probes import scale2_plain
    from semantic_dsp_map_tpu_torch.ops.probes_cuda import scale2_cuda

    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda)
    before = scale2_cuda.launches
    got = scale2_cuda(x)
    torch.cuda.synchronize()
    assert scale2_cuda.launches == before + 1
    assert got.shape == x.shape
    assert torch.equal(got.view(torch.int32), scale2_plain(x).view(torch.int32))
    with pytest.raises(ValueError):
        scale2_cuda(x.double())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [*range(1, 18), 100_003])
def test_gather_kernel_lengths_and_offsets(cuda, n):
    """The gather at every length from 1 to 17 (the kernel takes 8 lookups
    a thread, in quads of 4 from a 16-byte boundary) and at an odd large
    one, on index views that start 0-3 entries past a 16-byte boundary
    (rc[1:] of a whole tensor is a valid input): bytes equal, one launch."""
    from semantic_dsp_map_tpu_torch.benchmarks.prim_bench7 import make_inputs
    from semantic_dsp_map_tpu_torch.ops.probes import gather_plain
    from semantic_dsp_map_tpu_torch.ops.probes_cuda import gather_cuda

    depth, rc = make_inputs(cuda, 37, 53, n + 3, seed=n)
    for k in range(4):
        idx = rc[k:k + n]
        assert idx.is_contiguous() and idx.data_ptr() % 16 == 4 * k
        before = gather_cuda.launches
        got = gather_cuda(depth, idx)
        torch.cuda.synchronize()
        assert gather_cuda.launches == before + 1
        assert got.shape == (n,) and got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), gather_plain(depth, idx).view(torch.int32)), k


@pytest.mark.gpu
def test_gather_kernel_empty_index(cuda):
    """An empty index gives an empty f32 tensor on the card, as the plain
    version does, and launches nothing."""
    from semantic_dsp_map_tpu_torch.ops.probes import gather_plain
    from semantic_dsp_map_tpu_torch.ops.probes_cuda import gather_cuda

    depth = torch.rand((4, 5), device=cuda)
    rc = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = gather_cuda.launches
    got = gather_cuda(depth, rc)
    assert gather_cuda.launches == before
    want = gather_plain(depth, rc)
    assert got.shape == want.shape == (0,) and got.dtype == want.dtype == torch.float32
    assert got.device == want.device


@pytest.mark.gpu
def test_probe_kernels_in_a_cuda_graph(cuda):
    """Both probe kernels captured in a CUDA graph: each launches on the
    stream its wrapper reads as current, which under capture is the capture
    stream; replayed on new inputs (copied into the captured ones) they give
    the plain versions' bytes."""
    from semantic_dsp_map_tpu_torch.benchmarks.prim_bench7 import make_inputs
    from semantic_dsp_map_tpu_torch.ops.probes import gather_plain, scale2_plain
    from semantic_dsp_map_tpu_torch.ops.probes_cuda import gather_cuda, scale2_cuda

    depth, rc = make_inputs(cuda, 37, 53, 100_003, seed=1)
    x = torch.randn((8, 128), device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture asks
        gather_cuda(depth, rc)
        scale2_cuda(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (gather_cuda.launches, scale2_cuda.launches)
    with torch.cuda.graph(graph):
        g_out = gather_cuda(depth, rc)
        s_out = scale2_cuda(x)
    assert (gather_cuda.launches, scale2_cuda.launches) == (before[0] + 1, before[1] + 1)
    for seed in (2, 3):
        new_depth, new_rc = make_inputs(cuda, 37, 53, 100_003, seed=seed)
        depth.copy_(new_depth)
        rc.copy_(new_rc)
        x.copy_(torch.randn((8, 128), device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_out.view(torch.int32), gather_plain(depth, rc).view(torch.int32))
        assert torch.equal(s_out.view(torch.int32), scale2_plain(x).view(torch.int32))


def _faulty(t, fault):
    """``t`` with one fault a kernel wrapper refuses: another dtype, another
    shape, the same values laid out with a stride, or on the CPU."""
    if fault == "dtype":
        return t.double() if t.is_floating_point() else t.long()
    if fault == "shape":
        return t.unsqueeze(0)
    if fault == "strided":
        return torch.stack([t, t], -1)[..., 0]
    return t.cpu()


def _wrapper_cases(device):
    """(wrapper, arguments, [(argument name, position or Particles field)],
    {argument: the name a wrong shape of it is reported under}) for each of
    the eight kernel wrappers at the tiny config: every tensor but the one
    whose device decides between the kernel and the plain version.  The
    voxel count comes from one argument, so a wrong shape of that one is
    reported under the first store array checked against it."""
    from semantic_dsp_map_tpu_torch.ops.probes_cuda import gather_cuda, scale2_cuda

    cfg = tiny_test_config(phd_pixel_table_slots=4)
    params = FilterParams(detection_probability=0.9, noise_number=0.1, if_consider_depth_noise=True)
    t, c = _phd_inputs(cfg, device)
    a_args = _pass_a_args(cfg, params, t, c)
    _, b_args = _pass_b_args(cfg, params, t, c)
    s = _render_state(cfg, device, seed=3)
    vax = codecs.axis_stamps_per_voxel(cfg, s.scroll)
    p = s.particles
    _, _, r_cw, t_cw = camera_matrices(torch.tensor([0.4, -0.2, 0.7], device=device),
                                       torch.tensor([1.0, 0, 0, 0], device=device))
    n = cfg.num_voxels * cfg.slots_per_voxel
    pos = torch.rand(n, device=device)
    a_names = ("py", "pz", "weff", "trk", "obs_x", "obs_y", "obs_z", "inv_sigma", "obs_trk")
    b_names = ("py", "pz", "trk_eff", "ff_eff", "inv_sigma_p", "obs_x", "obs_y", "obs_z",
               "obs_valid", "obs_trk", "ck_kappa")
    depth = torch.rand((6, 7), device=device)
    rc = torch.randint(0, 42, (100,), dtype=torch.int32, device=device)
    return {
        "pass_a": (phd_cuda.pass_a_cuda, a_args, list(zip(a_names, range(3, 12))), {}),
        "pass_b": (phd_cuda.pass_b_cuda, b_args, list(zip(b_names, range(3, 14))), {}),
        "render": (render_core_cuda, (cfg, p, s.voxel_stamp, vax, 0.4),
                   [(f, f) for f in ("stamp", "status", "track", "label")]
                   + [("voxel_stamp", 2), ("vax", 3)], {"voxel_stamp": "weight"}),
        "front": (front_candidates_cuda, (cfg, pos, pos.clone(), pos.clone(), p.status, p.stamp,
                                          vax, r_cw, t_cw),
                  [("py", 2), ("pz", 3), ("status", 4), ("stamp", 5), ("vox_axis", 6)],
                  {"vox_axis": "px"}),
        "movable": (movable_voxels_cuda, (cfg, p.track, p.status, p.stamp, vax, 2),
                    [("status", 2), ("stamp", 3), ("vox_axis", 4)], {"vox_axis": "track"}),
        "gather": (gather_cuda, (depth, rc), [("rc", 1)], {}),
        "scale2": (scale2_cuda, (torch.rand((8, 128), device=device),), [("x", 0)], {}),
        "live_tracks": (phd_cuda.live_tracks_cuda,
                        (b_args[5], torch.zeros(b_args[5].shape, device=device),
                         torch.zeros(b_args[5].shape, dtype=torch.bool, device=device)),
                        [("acc", 1), ("right", 2)], {}),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["pass_a", "pass_b", "render", "front", "movable", "gather",
                                    "scale2", "live_tracks"])
@pytest.mark.parametrize("fault", ["dtype", "shape", "strided", "cpu"])
def test_wrappers_refuse_what_their_kernels_do_not_take(cuda, kernel, fault):
    """Each of the eight wrappers raises a ValueError that names the
    argument, before any launch, for every tensor argument of another dtype,
    another shape, a strided layout, or on the CPU among CUDA tensors.  The
    gather's table and x2's input take any shape, and x2 has no other tensor
    to put on the CPU (a CPU input runs the plain version)."""
    fn, args, targets, sized_by = _wrapper_cases(cuda)[kernel]
    if kernel == "scale2" and fault in ("shape", "cpu"):
        fault = "dtype"
    fn(*args)  # the arguments as they are pass
    torch.cuda.synchronize()
    for name, where in targets:
        if isinstance(where, str):  # a field of the particle store
            p = args[1]
            bad = list(args)
            bad[1] = dataclasses.replace(p, **{where: _faulty(getattr(p, where), fault)})
        else:
            bad = list(args)
            bad[where] = _faulty(args[where], fault)
        named = sized_by.get(name, name) if fault == "shape" else name
        before = fn.launches
        with pytest.raises(ValueError, match=f"^{named}: "):
            fn(*bad)
        assert fn.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_kernels_at_slab_shapes(cuda, D):
    """The five kernels of the sharded step at the shapes a rank of a D-rank
    run gives them: both PHD passes over a row slab's table
    [S, ceil(H/D) + 2R, W], the render, the candidate scan and the movable
    scan over a z-slab of V/D voxels; each against its plain version."""
    cfg = tiny_test_config(phd_pixel_table_slots=4)
    rows = -(-cfg.height // D) + 2 * cfg.neighbor_half
    params = FilterParams(detection_probability=0.9, noise_number=0.1, if_consider_depth_noise=True)
    t, c = _phd_inputs(tiny_test_config(phd_pixel_table_slots=4, image_height=rows), cuda, seed=D)
    assert t.px.shape == (4, rows, cfg.width)
    _check_pass_a(_pass_a_args(cfg, params, t, c))
    _ck, args = _pass_b_args(cfg, params, t, c)
    acc_p, right_p = phd.pass_b_raw(*args)
    acc_k, right_k = phd_cuda.pass_b_cuda(*args)
    torch.testing.assert_close(acc_k, acc_p, rtol=2e-5, atol=1e-6)
    assert torch.equal(right_k, right_p)

    slab = tiny_test_config(voxel_num_axis_z_n=cfg.voxel_num_axis_z_n - int(np.log2(D)))
    assert slab.num_voxels * D == cfg.num_voxels
    s = _render_state(slab, cuda, seed=D)
    vax = codecs.axis_stamps_per_voxel(slab, s.scroll)
    new, want = render_core_plain(slab, s.particles, s.voxel_stamp, vax, 0.4)
    p, got = render_core_cuda(slab, s.particles, s.voxel_stamp, vax, 0.4)
    for name in ("occ", "label", "track", "weight_sum"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(p.weight, new.weight) and torch.equal(p.status, new.status)

    n = slab.num_voxels * slab.slots_per_voxel
    rng = np.random.RandomState(D)
    T = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    _, _, r_cw, t_cw = camera_matrices(torch.tensor([0.4, -0.2, 0.7], device=cuda),
                                       torch.tensor([0.9622502, 0.0544331, 0.2613872, 0.0555144],
                                                    device=cuda))
    # the scan projects into the whole image: the configuration's, not the slab's rows
    front_args = (cfg, T(rng.randn(n) * 2), T(rng.randn(n) * 2), T(rng.rand(n) * 10 - 1),
                  p.status, p.stamp, vax, r_cw, t_cw)
    for g, w in zip(front_candidates_cuda(*front_args), front_candidates_plain(*front_args)):
        assert torch.equal(g, w)
    movable_args = (slab, p.track, p.status, p.stamp, vax, 2)
    want = movable_voxels_plain(*movable_args)
    assert torch.equal(movable_voxels_cuda(*movable_args), want) and int(want.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_sharded_step_at_one_rank_matches_single_device(cuda, packed):
    """The sharded step in a process group of one rank (NCCL on the card),
    every kernel on: the tiny dynamic scene's counters, state and render
    equal to the single-device step's on the card, and the five kernels of
    the path run once a frame (``kernel_runs``: from the second frame on the
    sharded step replays its graphs, which calls no wrapper)."""
    import torch.distributed as dist

    from semantic_dsp_map_tpu_torch.frontend import FrameInput, build_frame_input, pack_frame
    from semantic_dsp_map_tpu_torch.labels import LabelRegistry
    from semantic_dsp_map_tpu_torch.map import build_frame_step
    from semantic_dsp_map_tpu_torch.parallel import distributed
    from semantic_dsp_map_tpu_torch.parallel.shard_step import build_shard_step
    from semantic_dsp_map_tpu_torch.parallel.sharding import gather_render, shard_state
    from semantic_dsp_map_tpu_torch.state import map_state_to_numpy
    from torch_parity import dynamic_scene

    cfg = tiny_test_config()
    params = FilterParams(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                          depth_noise_model_zero_order=0.2, prediction_stddev=0.0)
    registry = LabelRegistry.default()
    kernels = (phd_cuda.pass_a_cuda, phd_cuda.pass_b_cuda, render_core_cuda, front_candidates_cuda,
               movable_voxels_cuda)
    distributed.initialize(device=cuda, rank=0, world_size=1)
    try:
        plain, sharded = build_frame_step(cfg, params, registry), build_shard_step(
            cfg, params, registry, packed=packed)
        s1 = init_map_state(cfg, 3, cuda)
        s2 = shard_state(cfg, init_map_state(cfg, 3, cuda), 0, 1)
        launches, moved = 0, 0
        for t in range(10):
            raw = dynamic_scene(cfg, t, MaskKpts)
            f = FrameInput(*(torch.as_tensor(np.asarray(a)).to(cuda)
                             for a in build_frame_input(cfg, registry, *raw)))
            s1, r1, d1 = plain(s1, f)
            before = [kernel_runs(k) for k in kernels]
            s2, r2, d2 = sharded(s2, torch.from_numpy(pack_frame(cfg, registry, *raw)).to(cuda)
                                 if packed else f)
            assert [kernel_runs(k) - b for k, b in zip(kernels, before)] == [1] * len(kernels)
            assert {k: int(v) for k, v in d2._asdict().items()} == {
                k: int(v) for k, v in d1._asdict().items()}, f"frame {t}"
            r2 = gather_render(r2)
            for name in ("occ", "label", "track", "weight_sum"):
                assert torch.equal(getattr(r2, name), getattr(r1, name)), f"{name} frame {t}"
            moved += int(d2.moved_count)
        assert moved > 0
        a, b = map_state_to_numpy(s1), map_state_to_numpy(s2)
        for key in a:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        del sharded  # its graphs go before the communicator they recorded
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_captured_sharded_step_equals_eager_on_the_card(cuda, packed):
    """``build_shard_step`` at one NCCL rank (frame 0 eager, frame 1
    captured, replays after: graphs "fit" and "finish" around the refit's
    eager SVD) against its eager oracle ``build_shard_step_eager`` on the
    card, 10 frames of the tiny dynamic scene with the noise on (depth
    noise and move jitter from the rank's generator, RANSAC triples from
    the state's): every tensor of the state by its bits, both generators,
    the render and the nine counters equal after every frame, also after a
    restored state (a generator of its own) is handed to both on frame 7;
    the five kernels run once a captured frame, all in graph "finish"."""
    import torch.distributed as dist

    from semantic_dsp_map_tpu_torch.labels import LabelRegistry
    from semantic_dsp_map_tpu_torch.parallel import distributed
    from semantic_dsp_map_tpu_torch.parallel.shard_step import (
        build_shard_step, build_shard_step_eager,
    )
    from semantic_dsp_map_tpu_torch.parallel.sharding import shard_state
    from torch_parity import dynamic_scene
    from torch_shard_worker import parted_names, restored_copy, step_input

    cfg = tiny_test_config()
    params = FilterParams(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                          depth_noise_model_zero_order=0.2, prediction_stddev=0.01)
    registry = LabelRegistry.default()
    kernels = (phd_cuda.pass_a_cuda, phd_cuda.pass_b_cuda, render_core_cuda, front_candidates_cuda,
               movable_voxels_cuda)
    kind = "packed" if packed else "frame"
    distributed.initialize(device=cuda, rank=0, world_size=1)
    try:
        captured = build_shard_step(cfg, params, registry, packed=packed)
        eager = build_shard_step_eager(cfg, params, registry, packed=packed)
        s_c = shard_state(cfg, init_map_state(cfg, 3, cuda), 0, 1)
        s_e = shard_state(cfg, init_map_state(cfg, 3, cuda), 0, 1)
        moved, saved = 0, None
        for t in range(10):
            if t == 5:
                saved = restored_copy(s_e)
            if t == 7:
                s_c, s_e = restored_copy(saved), restored_copy(saved)
            f = step_input(cfg, registry, dynamic_scene(cfg, t, MaskKpts), packed, cuda)
            before = [kernel_runs(k) for k in kernels]
            s_c, r_c, d_c = captured(s_c, f)
            assert [kernel_runs(k) - b for k, b in zip(kernels, before)] == [1] * len(kernels)
            s_e, r_e, d_e = eager(s_e, f)
            parted = parted_names((s_c, r_c, d_c, captured.stages.rank_rng.gen),
                             (s_e, r_e, d_e, eager.stages.rank_rng.gen))
            assert not parted, f"frame {t}: {parted}"
            graphs = captured.static.graphs
            assert set(graphs) == (set() if t == 0 else {(kind, "fit"), (kind, "finish")}), t
            if t:
                assert not any(graphs[kind, "fit"].launches.values())
            moved += int(d_c.moved_count)
        assert moved > 0
        del captured  # its graphs go before the communicator they recorded
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_collectives_record_into_a_graph(cuda):
    """The sharded step's collectives under CUDA-graph capture at one NCCL
    rank, as ``step_graph`` captures (``torch.cuda.graph``, its default
    capture mode): ``all_to_all_single`` and ``all_reduce``, each captured
    right after an eager one of its own kind (whose work the process group's
    watchdog may still hold), 20 times over; each capture succeeds and each
    replay gives what the eager collectives give on the replay's inputs."""
    import torch.distributed as dist

    from semantic_dsp_map_tpu_torch.parallel import distributed

    distributed.initialize(device=cuda, rank=0, world_size=1)
    try:
        x = torch.arange(64, dtype=torch.int32, device=cuda).view(16, 4)
        for i in range(20):
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x)
            total = x.sum(dim=1, dtype=torch.int64)
            dist.all_reduce(total)
            assert torch.equal(out, x) and torch.equal(total, x.sum(dim=1, dtype=torch.int64))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                y = torch.empty_like(x)
                dist.all_to_all_single(y, x * 2)
                s = y.sum(dim=1, dtype=torch.int64)
                dist.all_reduce(s)
            x.add_(i)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(y, x * 2), i
            assert torch.equal(s, (x * 2).sum(dim=1, dtype=torch.int64)), i
            del graph
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_a_sharded_capture_that_fails_raises(cuda, monkeypatch):
    """The sharded step at one NCCL rank whose object layer reads the device
    inside graph "fit" (before any collective is recorded): the first,
    eager frame runs, the capture on the second raises, and nothing steps
    back to eager."""
    import torch.distributed as dist

    from semantic_dsp_map_tpu_torch import map as map_module
    from semantic_dsp_map_tpu_torch.labels import LabelRegistry
    from semantic_dsp_map_tpu_torch.parallel import distributed
    from semantic_dsp_map_tpu_torch.parallel.shard_step import build_shard_step
    from semantic_dsp_map_tpu_torch.parallel.sharding import shard_state
    from torch_parity import dynamic_scene
    from torch_shard_worker import step_input

    inner = map_module.object_fit

    def reads_the_device(cfg, objects, *args):
        int(objects.valid.sum())  # a host read
        return inner(cfg, objects, *args)

    monkeypatch.setattr(map_module, "object_fit", reads_the_device)
    cfg = tiny_test_config()
    registry = LabelRegistry.default()
    distributed.initialize(device=cuda, rank=0, world_size=1)
    try:
        step = build_shard_step(cfg, FilterParams(), registry)
        state = shard_state(cfg, init_map_state(cfg, 0, cuda), 0, 1)
        state, _r, _d = step(state, step_input(cfg, registry, dynamic_scene(cfg, 0, MaskKpts),
                                               False, cuda))
        with pytest.raises(RuntimeError, match="capturing the frame step \\(fit\\)"):
            step(state, step_input(cfg, registry, dynamic_scene(cfg, 1, MaskKpts), False, cuda))
        del step
    finally:
        dist.destroy_process_group()


def _cummax_start(is_start):
    """The segment start as the port computed it before: ``torch.cummax``."""
    idx = torch.arange(is_start.shape[0], device=is_start.device)
    return torch.cummax(torch.where(is_start, idx, 0), dim=0).values


@pytest.mark.gpu
@pytest.mark.parametrize("captured", [False, True])
@pytest.mark.parametrize("n", [524_288, 262_144])  # observe's entry cap at VKITTI2 and ZED2
def test_segment_scans_match_cummax(cuda, n, captured):
    """``ops.blocks``' segment scans on the card, eagerly and replayed from a
    CUDA graph, against the ``torch.cummax`` form: equal integers at start
    densities 0 to 1."""
    from semantic_dsp_map_tpu_torch.ops import blocks

    rng = np.random.RandomState(n)
    for density in (0.0, 0.01, 0.3, 1.0):
        is_start = rng.rand(n) < density
        is_start[0] = True
        s = torch.from_numpy(is_start).to(cuda)
        keys = torch.cumsum(s, 0) * 7
        v = torch.from_numpy(rng.rand(n) < 0.6).to(cuda, torch.int64)

        def scans():
            return (blocks.segment_start_index(s), blocks.group_rank(keys),
                    blocks.segment_cumsum(v, s))

        if captured:
            scans()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = scans()
            graph.replay()
        else:
            got = scans()
        start = _cummax_start(s)
        cs = torch.cumsum(v, 0)
        want = (start, torch.arange(n, device=cuda) - start, cs - (cs[start] - v[start]))
        torch.cuda.synchronize()
        for name, x, y in zip(("segment_start_index", "group_rank", "segment_cumsum"), got, want):
            assert torch.equal(x, y), (name, density)


#: Birth's merge at the working-set shapes of the main path: (preset's
#: slots_n, bv, A, real rows, store blocks).  tiny: the tiny config's
#: birth; vkitti2: max_birth_blocks = 1536 rows of 64 voxels, K = 7; the
#: moving-object cleanup at VKITTI2 (2 x max_moving_blocks = 256 rows);
#: zed2: 1024 rows of 128 voxels, K = 3; k31: a store of 31 slots a voxel
#: (max_particle_num_per_voxel_n = 5), rows of 16 voxels; k63 to k1023: the
#: generic instance (a warp a voxel, two chunks of 32 slots a step) with
#: rows of 8, 4, 2 and 1 voxels, real rows no multiple of a block's eight
#: voxels; *_walk_bound and *_wipe: the working sets of
#: torch_parity.MERGE_KINDS (every slot UPDATED; the walk's K + 8 loop run
#: to its bound, and the wipe).
MERGE_SHAPES = {"tiny": (2, 128, 16, 11, 16), "vkitti2": (3, 64, 1536, 1400, 4096),
                "vkitti2_move": (3, 64, 256, 200, 4096), "zed2": (2, 128, 1024, 1000, 2048),
                "k31": (5, 16, 256, 201, 4096), "k63": (6, 8, 256, 201, 4096),
                "k127": (7, 4, 300, 233, 4096), "k255": (8, 2, 256, 201, 4096),
                "k1023": (10, 1, 77, 50, 1024),
                "k63_walk_bound": (6, 8, 256, 201, 4096, "walk_bound"),
                "k127_walk_bound": (7, 4, 300, 233, 4096, "walk_bound"),
                "k63_wipe": (6, 8, 256, 201, 4096, "wipe"),
                "k127_wipe": (7, 4, 300, 233, 4096, "wipe")}


def _merge_inputs(device, shape, seed):
    """tests/torch_parity.merge_working_set at a MERGE_SHAPES entry, as
    (cfg, flat, blocks, vox_axis, staged) on ``device``; the config's block
    layout is the shape's."""
    from semantic_dsp_map_tpu_torch.ops.birth import Staged
    from semantic_dsp_map_tpu_torch.ops.blocks import ActiveBlocks, block_layout
    from semantic_dsp_map_tpu_torch.state import Particles
    from torch_parity import merge_working_set

    slots_n, bv, A, n_real, nb, *kind = MERGE_SHAPES[shape]
    # a grid of nb * bv voxels whose block layout has bv voxels a block
    cfg = tiny_test_config(max_particle_num_per_voxel_n=slots_n,
                           voxel_num_axis_x_n=(nb * bv).bit_length() - 1 - 8,
                           voxel_num_axis_y_n=4, voxel_num_axis_z_n=4)
    assert block_layout(cfg)[:2] == (bv, nb), block_layout(cfg)
    d = merge_working_set(cfg.slots_per_voxel, bv, A, n_real, nb, seed, *kind)
    T = lambda k: torch.from_numpy(d[k]).to(device)
    flat = Particles(**{k: T(k) for k in ("px", "py", "pz", "weight", "label", "track", "status",
                                          "forget", "stamp")})
    blocks = ActiveBlocks(ids=T("ids"), count=torch.tensor(n_real, device=device),
                          overflow=torch.zeros((), dtype=torch.int64, device=device))
    staged = Staged(*(T(k) for k in ("in_px", "in_py", "in_pz", "in_w", "in_stamp", "in_meta")))
    return cfg, flat, blocks, T("vox_axis"), staged


def _same_store(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f.name


@pytest.mark.gpu
@pytest.mark.parametrize("resample", [False, True])
@pytest.mark.parametrize("shape", list(MERGE_SHAPES))
def test_merge_kernel_matches_plain(cuda, shape, resample):
    """Birth's merge kernel (csrc/birth.cu) against merge_blocks_plain on
    the same inputs, padding rows among them: the store's bits and the
    accepted count (a 0-d int64 tensor) equal; one launch."""
    from semantic_dsp_map_tpu_torch.ops.birth import merge_blocks_plain
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import merge_blocks_cuda

    cfg, flat_p, blocks, vax, staged = _merge_inputs(cuda, shape, seed=7)
    flat_k = _merge_inputs(cuda, shape, seed=7)[1]
    _, acc_p = merge_blocks_plain(cfg, flat_p, blocks, vax, staged, resample)
    before = merge_blocks_cuda.launches
    _, acc_k = merge_blocks_cuda(cfg, flat_k, blocks, vax, staged, resample)
    torch.cuda.synchronize()
    assert merge_blocks_cuda.launches == before + 1
    assert acc_k.dtype == acc_p.dtype and acc_k.shape == acc_p.shape == ()
    assert int(acc_k) == int(acc_p) > 0
    _same_store(flat_k, flat_p)


@pytest.mark.gpu
@pytest.mark.parametrize("resample", [False, True])
@pytest.mark.parametrize("shape", ["tiny", "vkitti2", "zed2", "k31"])
def test_merge_kernel_in_a_cuda_graph(cuda, shape, resample):
    """The merge kernel captured into a CUDA graph (its accepted count
    zeroed inside the graph) and replayed on new inputs copied into the
    captured ones: the plain version's bits every replay."""
    from semantic_dsp_map_tpu_torch.ops.birth import merge_blocks_plain
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import merge_blocks_cuda

    cfg, flat, blocks, vax, staged = _merge_inputs(cuda, shape, seed=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture asks
        merge_blocks_cuda(cfg, flat, blocks, vax, staged, resample)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, acc = merge_blocks_cuda(cfg, flat, blocks, vax, staged, resample)
    for seed in (2, 3):
        _, new, new_blocks, new_vax, new_staged = _merge_inputs(cuda, shape, seed=seed)
        for f in dataclasses.fields(flat):
            getattr(flat, f.name).copy_(getattr(new, f.name))
        blocks.ids.copy_(new_blocks.ids)
        vax.copy_(new_vax)
        for x, y in zip(staged, new_staged):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        _, acc_p = merge_blocks_plain(cfg, new, new_blocks, new_vax, new_staged, resample)
        assert int(acc) == int(acc_p) > 0
        _same_store(flat, new)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["dtype", "shape", "strided", "cpu"])
def test_merge_wrapper_refuses_what_its_kernel_does_not_take(cuda, fault):
    """merge_blocks_cuda raises a ValueError that names the argument,
    before any launch, for each tensor of another dtype, another shape, a
    strided layout, or on the CPU among CUDA tensors: the store's fields
    but px (whose device decides, and whose length sizes the others), the
    scroll stamps, the block ids and the six staged buffers (named in_*)."""
    from semantic_dsp_map_tpu_torch.ops.birth import Staged
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import merge_blocks_cuda

    cfg, flat, blocks, vax, staged = _merge_inputs(cuda, "tiny", seed=5)
    merge_blocks_cuda(cfg, flat, blocks, vax, staged, True)  # as they are, they pass
    torch.cuda.synchronize()

    def faulty(t):
        if fault == "dtype" and t.dtype == torch.int64:
            return t.int()
        return _faulty(t, fault)

    cases = [(f.name, lambda bad, f=f.name: (dataclasses.replace(flat, **{f: bad}), blocks, vax,
                                             staged), getattr(flat, f.name))
             for f in dataclasses.fields(flat) if f.name != "px"]
    cases.append(("vox_axis", lambda bad: (flat, blocks, bad, staged), vax))
    cases.append(("ids", lambda bad: (flat, blocks._replace(ids=bad), vax, staged), blocks.ids))
    cases += [("in_" + name, lambda bad, name=name: (flat, blocks, vax,
                                                     staged._replace(**{name: bad})),
               getattr(staged, name)) for name in Staged._fields]
    for name, args_with, t in cases:
        before = merge_blocks_cuda.launches
        with pytest.raises(ValueError, match=f"^{name}: "):
            merge_blocks_cuda(cfg, *args_with(faulty(t)), True)
        assert merge_blocks_cuda.launches == before, name


@pytest.mark.gpu
@pytest.mark.parametrize("captured", [False, True])
@pytest.mark.parametrize("resample", [False, True])
@pytest.mark.parametrize("shape", list(MERGE_SHAPES))
def test_merge_acceptance_instance_matches_plain(cuda, shape, resample, captured):
    """The merge kernel's instance that writes the per-lane acceptance
    (``merge_blocks_accepted_cuda``, what ``insert_particles`` runs) against
    ``merge_blocks_plain(..., want_accepted=True)``: the store's bits, the
    count and the [A, bv, K] mask equal, padding rows all False; eagerly,
    or captured into a CUDA graph and replayed on new inputs.  The
    count-only instance on a third copy gives the same bits and count."""
    from semantic_dsp_map_tpu_torch.ops.birth import merge_blocks_plain
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import (
        merge_blocks_accepted_cuda, merge_blocks_cuda,
    )

    cfg, flat, blocks, vax, staged = _merge_inputs(cuda, shape, seed=1 if captured else 7)
    run = lambda: merge_blocks_cuda(cfg, flat, blocks, vax, staged, resample, want_accepted=True)
    if captured:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the default stream, as capture asks
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _, acc, mask = run()
    seeds = (2, 3) if captured else (7,)
    for seed in seeds:
        _, new, new_blocks, new_vax, new_staged = _merge_inputs(cuda, shape, seed=seed)
        count_only = _merge_inputs(cuda, shape, seed=seed)[1]
        before = (merge_blocks_accepted_cuda.launches, merge_blocks_cuda.launches)
        if captured:
            for f in dataclasses.fields(flat):
                getattr(flat, f.name).copy_(getattr(new, f.name))
            blocks.ids.copy_(new_blocks.ids)
            vax.copy_(new_vax)
            for x, y in zip(staged, new_staged):
                x.copy_(y)
            graph.replay()
        else:
            _, acc, mask = run()
            assert (merge_blocks_accepted_cuda.launches, merge_blocks_cuda.launches) == (
                before[0] + 1, before[1])
        _, acc_c = merge_blocks_cuda(cfg, count_only, new_blocks, new_vax, new_staged, resample)
        torch.cuda.synchronize()
        _, acc_p, mask_p = merge_blocks_plain(cfg, new, new_blocks, new_vax, new_staged, resample,
                                              want_accepted=True)
        assert mask.dtype == torch.bool and mask.shape == mask_p.shape == staged.meta.shape
        assert torch.equal(mask, mask_p)
        assert int(acc) == int(acc_c) == int(acc_p) == int(mask.sum()) > 0
        assert not bool(mask[int(blocks.count):].any())
        _same_store(flat, new)
        _same_store(count_only, new)


@pytest.mark.gpu
@pytest.mark.parametrize("filt", ["joint", "independent"])
def test_phd_weight_update_kernels_match_plain(cuda, filt):
    """``compute_ck_kappa`` and ``phd_weight_update`` over a VisibleSet on
    the card: with ``use_pallas_phd`` (both CUDA passes, each launched once)
    against the plain stencils on the same card, on copies of one store: the
    floats within rtol 2e-5 / atol 1e-6, forget, status and stamp equal; a
    crowded pixel ranks past S."""
    from semantic_dsp_map_tpu_torch.ops.projection import visible_set_from_numpy
    from semantic_dsp_map_tpu_torch.state import Particles
    from torch_parity import merge_working_set

    rng = np.random.RandomState(3)
    cfg = tiny_test_config(phd_neighbor_half=2, phd_pixel_table_slots=4)
    plain_cfg = dataclasses.replace(cfg, use_pallas_phd=False)
    params = FilterParams(detection_probability=0.9, noise_number=0.05, forgetting_rate=1.0,
                          max_forget_count=3, id_transition_probability=0.2,
                          if_use_independent_filter=filt == "independent")
    H, W, K, V = cfg.height, cfg.width, cfg.slots_per_voxel, cfg.num_voxels
    P, n = 400, 360
    row, col = rng.randint(0, H, P), rng.randint(0, W, P)
    row[:12], col[:12] = 5, 7  # a pixel of 12 entries, 4 slots
    cloud_pos = (rng.randn(H, W, 3) * 0.5).astype(np.float32)
    vis = dict(vox=np.where(np.arange(P) < n, rng.permutation(V)[:P], -1),
               slot=rng.randint(0, K, P), row=row, col=col,
               pos=cloud_pos[row, col] + rng.randn(P, 3) * 0.1,
               weight=rng.choice([0.1, 0.2, 0.3], P), track=rng.randint(0, 3, P),
               forget=rng.randint(0, 6, P), visible=rng.rand(P) < 0.9, count=0)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    sigma = (0.05 + rng.rand(H, W) * 0.2).astype(np.float32)
    cloud = LabeledCloud(pos=T(cloud_pos), sigma=T(sigma),
                         label=T(np.zeros((H, W), np.int32)),
                         track=T(rng.randint(0, 3, (H, W)).astype(np.int32)),
                         valid=T(rng.rand(H, W) > 0.3))
    v = visible_set_from_numpy(vis, cuda)
    d = merge_working_set(K, V, 1, 1, 1, seed=5)  # a random store of V * K slots
    store = lambda: Particles(**{k: T(d[k].copy()) for k in (
        "px", "py", "pz", "weight", "label", "track", "status", "forget", "stamp")})
    ck_k = phd.compute_ck_kappa(cfg, params, v, cloud)
    ck_p = phd.compute_ck_kappa(plain_cfg, params, v, cloud)
    torch.testing.assert_close(ck_k, ck_p, rtol=2e-5, atol=1e-6)
    runs = (phd_cuda.pass_a_cuda.launches, phd_cuda.pass_b_cuda.launches)
    p_k, p_p = store(), store()
    phd.phd_weight_update(cfg, params, v, cloud, p_k, 7)
    phd.phd_weight_update(plain_cfg, params, v, cloud, p_p, 7)
    torch.cuda.synchronize()
    assert (phd_cuda.pass_a_cuda.launches, phd_cuda.pass_b_cuda.launches) == (
        runs[0] + 1, runs[1] + 1)
    assert int(phd.build_pixel_table(cfg, v).dropped) > 0
    torch.testing.assert_close(p_k.weight, p_p.weight, rtol=2e-5, atol=1e-6)
    for name in ("forget", "status", "stamp", "px", "track"):
        assert torch.equal(getattr(p_k, name), getattr(p_p, name)), name
    assert int((p_k.stamp == 7).sum()) > 100


# ---------------------------------------------------------------------------
# Template mode's gate and delete kernels (csrc/templates.cu)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(375, 1242), (7, 13)])  # VKITTI2's H * W = 465,750; odd
@pytest.mark.parametrize("O", [64, 8, 300])  # 300: two chunks of rows
@pytest.mark.parametrize("kind", TEMPLATE_GATE_EDGES)
def test_template_gate_kernel_matches_plain(cuda, kind, O, shape):
    """The gate kernel gives ``template_gate``'s i32[O, 8] on the card bit for
    bit at every edge of ``torch_parity.template_gate_case``: no matching
    pixel, one, every pixel (no fill in the max) or every valid one, rows
    sharing an id (one invalid), the -1 rows, NaN / +-0.0 / +-inf
    coordinates, extents past int32 after * 1000."""
    from semantic_dsp_map_tpu_torch.ops.templates_cuda import template_gate_cuda
    from semantic_dsp_map_tpu_torch.template_engine import template_gate

    objects, cloud = template_gate_tensors(kind, O, *shape, cuda)
    before = template_gate_cuda.launches
    got = template_gate_cuda(GATE_CAR, objects, cloud)
    want = template_gate(GATE_CAR, objects, cloud)
    torch.cuda.synchronize()
    assert template_gate_cuda.launches == before + 1
    assert got.shape == want.shape == (O, 8) and got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want), (kind, O, shape, (got != want).nonzero()[:8].tolist())
    if kind == "every":  # every pixel on row 0: the plain max takes no fill
        assert int(want[0, 5]) == shape[0] * shape[1]


def _delete_inputs(kind, n, device):
    track, status, good, tid = template_delete_case(kind, n)
    return track, status, good, tid, tuple(
        torch.from_numpy(a).to(device) for a in (track, status, good, tid))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [58_720_256, 1001])  # the VKITTI2 store; a ragged tail
@pytest.mark.parametrize("kind", TEMPLATE_DELETE_EDGES)
def test_delete_kernel_matches_plain(cuda, kind, n):
    """The delete kernel leaves the whole status equal to the plain pass's
    and to its definition, and track untouched: neither slot good, one, both,
    one id in both, an id absent from the store, an id on every slot."""
    from semantic_dsp_map_tpu_torch.ops.templates_cuda import delete_matched_cuda
    from semantic_dsp_map_tpu_torch.template_engine import delete_matched_plain

    track, status, good, tid, (t, s, g, i) = _delete_inputs(kind, n, cuda)
    plain = s.clone()
    delete_matched_plain(t, plain, g, i)
    before = delete_matched_cuda.launches
    delete_matched_cuda(t, s, g, i)
    torch.cuda.synchronize()
    assert delete_matched_cuda.launches == before + 1
    assert torch.equal(s, plain), kind
    assert torch.equal(s.cpu(), torch.from_numpy(deleted_as_expected(track, status, good, tid)))
    assert torch.equal(t.cpu(), torch.from_numpy(track))


@pytest.mark.gpu
def test_template_kernels_in_a_cuda_graph(cuda):
    """Both kernels captured into a CUDA graph (the gate's scratch zeroed by a
    memset node): replayed with a good slot and then with none (the flags
    rewritten in place), each replay gives the plain versions' bits."""
    from semantic_dsp_map_tpu_torch.ops.templates_cuda import (
        delete_matched_cuda, template_gate_cuda,
    )
    from semantic_dsp_map_tpu_torch.template_engine import delete_matched_plain, template_gate

    objects, cloud = template_gate_tensors("random", 64, 375, 1242, cuda)
    _, status, _, _, (t, s, g, i) = _delete_inputs("one", 1 << 20, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture asks
        template_gate_cuda(GATE_CAR, objects, cloud)
        delete_matched_cuda(t, s.clone(), g, i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gate = template_gate_cuda(GATE_CAR, objects, cloud)
        delete_matched_cuda(t, s, g, i)
    original = torch.from_numpy(status).to(cuda)
    for flags in ((True, False), (False, False)):
        g.copy_(torch.tensor(flags, device=cuda))
        s.copy_(original)
        gate.zero_()
        graph.replay()
        plain = original.clone()
        delete_matched_plain(t, plain, g, i)
        torch.cuda.synchronize()
        assert torch.equal(gate, template_gate(GATE_CAR, objects, cloud)), flags
        assert torch.equal(s, plain), flags
    assert torch.equal(s, original)  # no slot good: nothing deleted


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["dtype", "shape", "strided", "cpu"])
def test_template_wrappers_refuse_what_their_kernels_do_not_take(cuda, fault):
    """Both wrappers raise a ValueError that names the argument, before any
    launch, for every tensor of another dtype, shape, a strided layout, or on
    the CPU among CUDA tensors (but the one whose device decides between the
    kernel and the plain version).  A shape is read from one tensor (the
    cloud's from its track, the store's from track, the slots' from good),
    so a wrong one is reported under the next tensor checked against it."""
    import types

    from semantic_dsp_map_tpu_torch.ops.templates_cuda import (
        delete_matched_cuda, template_gate_cuda,
    )

    objects, cloud = template_gate_tensors("random", 8, 7, 13, cuda)
    sized_by = {"cloud.track": "cloud.valid", "track": "status", "good": "tid"}
    for name in ("cloud.track", "cloud.valid", "cloud.pos", "objects.valid",
                 "objects.to_match_previous", "objects.moving", "objects.has_moved_record",
                 "objects.to_match_templates", "objects.track_id", "objects.label"):
        if name == "cloud.track" and fault == "cpu":
            continue
        part, field = name.split(".")
        o, c = objects, cloud
        if part == "cloud":
            c = cloud._replace(**{field: _faulty(getattr(cloud, field), fault)})
        else:
            o = types.SimpleNamespace(**{**vars(objects),
                                         field: _faulty(getattr(objects, field), fault)})
        named = sized_by.get(name, name) if fault == "shape" else name
        before = template_gate_cuda.launches
        with pytest.raises(ValueError, match=f"^{named}: "):
            template_gate_cuda(GATE_CAR, o, c)
        assert template_gate_cuda.launches == before
    args = list(_delete_inputs("one", 1001, cuda)[4])
    for k, name in enumerate(("track", "status", "good", "tid")):
        if name == "track" and fault == "cpu":
            continue
        bad = list(args)
        bad[k] = _faulty(args[k], fault)
        named = sized_by.get(name, name) if fault == "shape" else name
        before = delete_matched_cuda.launches
        with pytest.raises(ValueError, match=f"^{named}: "):
            delete_matched_cuda(*bad)
        assert delete_matched_cuda.launches == before


@pytest.mark.gpu
def test_template_kernels_spill_nothing(cuda):
    """ptxas fits the gate's two kernels and the delete kernel in the
    registers that let their blocks fill an SM (the gate's four blocks of
    256 threads, the delete's eight), with no spill."""
    from semantic_dsp_map_tpu_torch.ops import cuda_lib

    _, _, log = cuda_lib.build()
    found = _ptxas_functions(log)
    limits = {"22gate_accumulate_kernel": 64, "18gate_finish_kernel": 64,
              "21delete_matched_kernel": 32}
    for key, limit in limits.items():
        hits = [v for name, v in found.items() if key in name]
        assert len(hits) == 1, (key, sorted(found))
        regs, spill = hits[0]
        assert regs <= limit and spill == 0, (key, regs, spill)
