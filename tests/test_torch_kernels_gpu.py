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
    PHD_EDGE_TABLES, STORE_EDGES, ZERO_FF_ENTRY, particle_store, phd_table_cloud, render_store,
    zed2_scene,
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
@pytest.mark.parametrize("S,R,h,w", [(12, 5, 40, 70), (12, phd_cuda.MAX_R, 40, 70), (40, 5, 19, 40),
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


@pytest.mark.gpu
def test_pass_a_kernel_refuses_a_wide_stencil(cuda):
    cfg = tiny_test_config(phd_pixel_table_slots=4, phd_neighbor_half=phd_cuda.MAX_R + 1)
    params = FilterParams()
    t, c = _phd_inputs(cfg, cuda)
    with pytest.raises(ValueError):
        phd_cuda.pass_a_cuda(*_pass_a_args(cfg, params, t, c))


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
def test_pass_b_kernel_large_shared_memory(cuda):
    """The widest stencil the kernels take (R = 8) with 40 slots needs more
    than 48 KB of shared memory for the halo and the work list; a wider
    stencil raises."""
    cfg = tiny_test_config(image_width=53, image_height=37, phd_pixel_table_slots=40,
                           phd_neighbor_half=phd_cuda.MAX_R)
    params = FilterParams(detection_probability=0.9, noise_number=0.1, if_consider_depth_noise=True)
    t, c = _phd_inputs(cfg, cuda, seed=6, fill=0.1, front_fill=True)
    _, args = _pass_b_args(cfg, params, t, c)
    acc_p, right_p = phd.pass_b_raw(*args)
    acc_k, right_k = phd_cuda.pass_b_cuda(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(acc_k, acc_p, rtol=2e-5, atol=1e-6)
    assert torch.equal(right_k, right_p)
    wide = tiny_test_config(image_width=53, image_height=37, phd_pixel_table_slots=40,
                            phd_neighbor_half=phd_cuda.MAX_R + 1)
    with pytest.raises(ValueError):
        phd_cuda.pass_b_cuda(wide, *args[1:])


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

    d = render_store(V, K, seed, kind)
    T = lambda a: torch.from_numpy(a).to(device)
    n = V * K
    zeros = torch.zeros(n, device=device)
    p = Particles(px=zeros, py=zeros, pz=zeros, weight=T(d["weight"]), label=T(d["label"]),
                  track=T(d["track"]), status=T(d["status"]),
                  forget=torch.zeros(n, dtype=torch.uint8, device=device), stamp=T(d["stamp"]))
    return p, T(d["voxel_stamp"]), T(d["vax"])


@pytest.mark.gpu
@pytest.mark.parametrize("V", [1, 1023, 4099, 3 * 1024 + 1])
@pytest.mark.parametrize("slots_n", [1, 2, 3, 4])  # K = 1, 3, 7, 15
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
@pytest.mark.parametrize("slots_n", [1, 2, 3, 4])  # K = 1, 3, 7, 15
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
        assert 0 < int(want[1].sum()) < V


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
    the seven kernel wrappers at the tiny config: every tensor but the one
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
    }


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["pass_a", "pass_b", "render", "front", "movable", "gather",
                                    "scale2"])
@pytest.mark.parametrize("fault", ["dtype", "shape", "strided", "cpu"])
def test_wrappers_refuse_what_their_kernels_do_not_take(cuda, kernel, fault):
    """Each of the seven wrappers raises a ValueError that names the
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
    the path launched once a frame."""
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
            before = [k.launches for k in kernels]
            s2, r2, d2 = sharded(s2, torch.from_numpy(pack_frame(cfg, registry, *raw)).to(cuda)
                                 if packed else f)
            assert [k.launches - b for k, b in zip(kernels, before)] == [1] * len(kernels)
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
    finally:
        dist.destroy_process_group()
