"""Wrappers of the hand-written CUDA PHD kernels (csrc/phd.cu).

They replace ``pass_a_pallas`` / ``pass_b_pallas`` of
``semantic_dsp_map_tpu/ops/phd_pallas.py`` (the TPU kernels
``_pass_a_kernel`` / ``_pass_b_kernel``) and take the same arguments.  On a
CUDA tensor they launch the kernel; on a CPU tensor they run the plain
stencils of ops/phd.py, their oracle.  Every half-width R and table depth
S runs on the card: past what the main instances' shared memory holds, a
call is two launches, the table's live planes found by one streaming pass
(``live_weights_cuda`` / ``live_tracks_cuda``, plain version
``ops.phd.live_planes``) and the pass's wide instance on its words
(``ops.phd.window_half`` caps R at max(H, W) - 1, where every window covers
the image).  Bound and design: see the note at the top of csrc/phd.cu.

``pass_a_cuda.launches`` / ``pass_b_cuda.launches`` count the passes'
launches (one a call, whichever instance runs), ``live_weights_cuda`` and
``live_tracks_cuda`` theirs.
"""

from __future__ import annotations

import functools

import torch

from ..config import FilterParams, GAUSSIAN_PDF_COEF, MIN_RIGHTLY_UPDATED_PDF, MapConfig
from . import cuda_lib
from .phd import live_planes, pass_a_raw, pass_b_raw, window_half

_COEF3 = GAUSSIAN_PDF_COEF ** 3

#: Argument names of the tensors the wrappers check together.
_A_PLANES = ("px", "py", "pz", "weff")
_A_OBS = ("obs_x", "obs_y", "obs_z", "inv_sigma")
_B_PLANES = ("px", "py", "pz", "ff_eff")
_B_OBS = ("inv_sigma_p", "obs_x", "obs_y", "obs_z", "ck_kappa")


@functools.cache
def _wide(name: str, S: int, H: int, W: int, R: int) -> bool:
    """Whether the pass of C entry point ``name`` (``dsp_pass_a_is_wide`` or
    ``dsp_pass_b_is_wide``) runs its wide instance at this shape."""
    return bool(getattr(cuda_lib.entry, name)(S, H, W, R))


def _live_words(plane: torch.Tensor, name: str) -> torch.Tensor:
    """The live words' tensor for table plane ``plane`` (argument ``name``)."""
    if plane.dim() != 3:
        raise ValueError(f"{name}: expected an [S, H, W] tensor, got shape {tuple(plane.shape)}")
    S, H, W = plane.shape
    return torch.empty((-(-S // 32), H, W), dtype=torch.int32, device=plane.device)


@cuda_lib.counted
def live_weights_cuda(weff: torch.Tensor) -> torch.Tensor:
    """Pass A's live planes: i32 words [ceil(S/32), H, W], bit b of word
    (g, y, x) set where ``weff[32g + b, y, x] != 0`` (ops.phd.live_planes)."""
    index = weff.get_device()
    if index < 0:  # the CPU: the plain version
        return live_planes(weff != 0)
    live = _live_words(weff, "weff")
    S, H, W = weff.shape
    (ptr,) = cuda_lib.pointers(index, torch.float32, weff.shape, (weff,), ("weff",))
    err = cuda_lib.entry.dsp_live_planes(ptr, live.data_ptr(), None, None, S, H, W, 0,
                                         cuda_lib.stream_ptr(index))
    if err:
        raise cuda_lib.error(err, "dsp_live_planes")
    live_weights_cuda.launches += 1
    return live


@cuda_lib.counted
def live_tracks_cuda(trk_eff: torch.Tensor, acc: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Pass B's live planes (``trk_eff != -2``), as ``live_weights_cuda``'s;
    writes acc = 0 and right = False at every empty entry of acc f32 and
    right bool [S, H, W] and leaves the occupied ones as they are."""
    index = trk_eff.get_device()
    if index < 0:  # the CPU: the plain version
        occupied = trk_eff != -2
        acc.masked_fill_(~occupied, 0.0)
        right.masked_fill_(~occupied, False)
        return live_planes(occupied)
    live = _live_words(trk_eff, "trk_eff")
    S, H, W = shape = trk_eff.shape
    (trk,) = cuda_lib.pointers(index, torch.int32, shape, (trk_eff,), ("trk_eff",))
    (acc_ptr,) = cuda_lib.pointers(index, torch.float32, shape, (acc,), ("acc",))
    (right_ptr,) = cuda_lib.pointers(index, torch.bool, shape, (right,), ("right",))
    err = cuda_lib.entry.dsp_live_planes(trk, live.data_ptr(), acc_ptr, right_ptr, S, H, W, 1,
                                         cuda_lib.stream_ptr(index))
    if err:
        raise cuda_lib.error(err, "dsp_live_planes")
    live_tracks_cuda.launches += 1
    return live


@cuda_lib.counted
def pass_a_cuda(
    cfg: MapConfig,
    params: FilterParams,
    px, py, pz, weff, trk,                    # [S, H, W]
    obs_x, obs_y, obs_z, inv_sigma, obs_trk,  # [H, W]
) -> torch.Tensor:
    """Raw per-pixel ck, f32[H, W] (see ops.phd.pass_a_raw)."""
    index = px.get_device()
    if index < 0:  # the CPU: the plain version
        return pass_a_raw(cfg, params, px, py, pz, weff, trk,
                          obs_x, obs_y, obs_z, inv_sigma, obs_trk)
    S, H, W = shape = px.shape
    R = window_half(cfg.neighbor_half, H, W)
    f32, i32 = torch.float32, torch.int32
    ptrs = cuda_lib.pointers(index, f32, shape, (px, py, pz, weff), _A_PLANES)
    ptrs += cuda_lib.pointers(index, i32, shape, (trk,), ("trk",))
    ptrs += cuda_lib.pointers(index, f32, (H, W), (obs_x, obs_y, obs_z, inv_sigma), _A_OBS)
    ptrs += cuda_lib.pointers(index, i32, (H, W), (obs_trk,), ("obs_trk",))
    ck = torch.empty((H, W), dtype=f32, device=px.device)
    rest = (S, H, W, R, _COEF3, params.id_transition_probability,
            int(params.if_use_independent_filter), cuda_lib.stream_ptr(index))
    if _wide("dsp_pass_a_is_wide", S, H, W, R):
        live = live_weights_cuda(weff)
        err = cuda_lib.entry.dsp_pass_a_wide(*ptrs, live.data_ptr(), ck.data_ptr(), *rest)
    else:
        err = cuda_lib.entry.dsp_pass_a(*ptrs, ck.data_ptr(), *rest)
    if err:
        raise cuda_lib.error(err, "dsp_pass_a")
    pass_a_cuda.launches += 1
    return ck


@cuda_lib.counted
def pass_b_cuda(
    cfg: MapConfig,
    params: FilterParams,
    px, py, pz,            # [S, H, W] particle positions
    trk_eff,               # [S, H, W] i32: track id, or -2 where empty
    ff_eff,                # [S, H, W] f32: forgetting factor, 0 where empty
    inv_sigma_p,           # [H, W] f32
    obs_x, obs_y, obs_z,   # [H, W]
    obs_valid,             # bool[H, W]
    obs_trk,               # i32[H, W]
    ck_kappa,              # f32[H, W]
):
    """(acc f32[S, H, W], right bool[S, H, W]) (see ops.phd.pass_b_raw)."""
    index = px.get_device()
    if index < 0:  # the CPU: the plain version
        return pass_b_raw(cfg, params, px, py, pz, trk_eff, ff_eff, inv_sigma_p,
                          obs_x, obs_y, obs_z, obs_valid, obs_trk, ck_kappa)
    S, H, W = shape = px.shape
    R = window_half(cfg.neighbor_half, H, W)
    f32, i32 = torch.float32, torch.int32
    *planes, ff = cuda_lib.pointers(index, f32, shape, (px, py, pz, ff_eff), _B_PLANES)
    *obs, ck = cuda_lib.pointers(index, f32, (H, W),
                                 (inv_sigma_p, obs_x, obs_y, obs_z, ck_kappa), _B_OBS)
    (trk,) = cuda_lib.pointers(index, i32, shape, (trk_eff,), ("trk_eff",))
    (valid,) = cuda_lib.pointers(index, torch.bool, (H, W), (obs_valid,), ("obs_valid",))
    (otrk,) = cuda_lib.pointers(index, i32, (H, W), (obs_trk,), ("obs_trk",))
    acc = torch.empty(shape, dtype=f32, device=px.device)
    right = torch.empty(shape, dtype=torch.bool, device=px.device)
    inputs = (*planes, trk, ff, *obs, valid, otrk, ck)
    rest = (S, H, W, R, _COEF3, params.id_transition_probability, MIN_RIGHTLY_UPDATED_PDF,
            int(params.if_use_independent_filter), cuda_lib.stream_ptr(index))
    if _wide("dsp_pass_b_is_wide", S, H, W, R):
        live = live_tracks_cuda(trk_eff, acc, right)
        err = cuda_lib.entry.dsp_pass_b_wide(*inputs, live.data_ptr(), acc.data_ptr(),
                                             right.data_ptr(), *rest)
    else:
        err = cuda_lib.entry.dsp_pass_b(*inputs, acc.data_ptr(), right.data_ptr(), *rest)
    if err:
        raise cuda_lib.error(err, "dsp_pass_b")
    pass_b_cuda.launches += 1
    return acc, right
