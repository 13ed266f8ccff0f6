"""SMC-PHD particle weight update (counterpart of
``semantic_dsp_map_tpu/ops/phd.py``; SemanticDSPMap::updateParticles,
semantic_dsp_map.h:960-1121).

The visible particles sit in a dense per-pixel table ``[S, H, W]``; both
passes are (2R+1)^2-offset stencils over it:

  Pass A (normalizer): ck[q] = sum over particles p within +-R pixels of q
      of w_p * N^3(pos_p; obs_q, sigma_q) * [forgetting, id-transition],
      ck_kappa = ck * P_d + kappa.
  Pass B (update): each particle accumulates gk / ck_kappa over the valid
      observation pixels of the same neighborhood; weight *= acc*P_d + 1-P_d;
      the forget counter resets iff a same-track observation matched with
      pdf > 0.1, else it increments (saturating at the literal 5).

``pass_a_raw`` / ``pass_b_raw`` are the plain PyTorch stencils, a direct
port of the JAX package's XLA stencils and the oracle of the CUDA kernels in
the port's ops/phd_cuda.py.  ``stencil_passes`` runs the plain stencils
on every device.

"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import (
    FORGET_COUNT_INCREMENT_CAP,
    FilterParams,
    GAUSSIAN_PDF_COEF,
    GAUSSIAN_PDF_Z_CLIP,
    MIN_RIGHTLY_UPDATED_PDF,
    MapConfig,
)
from .geometry import forgetting_factor
from .projection import LabeledCloud

_COEF3 = GAUSSIAN_PDF_COEF ** 3


class PixelTable(NamedTuple):
    """Dense per-pixel particle table, all [S, H, W]; ``meta`` packs
    (track << 8) | forget, -1 marks an empty slot."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    weight: torch.Tensor
    meta: torch.Tensor
    dropped: torch.Tensor  # i64 scalar: entries that overflowed their pixel


def gauss3(dx, dy, dz, inv_sigma):
    """Fused 3-axis reference 'pdf': COEF^3 * exp(-(zx^2+zy^2+zz^2)/2), zero
    when any axis passes the reference LUT's 9.9-sigma clamp."""
    zx = dx * inv_sigma
    zy = dy * inv_sigma
    zz = dz * inv_sigma
    s = zx * zx + zy * zy + zz * zz
    amax = torch.maximum(torch.maximum(zx.abs(), zy.abs()), zz.abs())
    val = _COEF3 * torch.exp(-0.5 * s)
    return torch.where(amax > GAUSSIAN_PDF_Z_CLIP, 0.0, val)


def table_from_entries(
    cfg: MapConfig, pix, rank, keep, px, py, pz, weight, track, forget, n_rows: int = 0
) -> PixelTable:
    """Scatter compact entries into the dense table; kept (pix, rank) pairs
    are unique.  ``pix >= H*W`` marks padding.  ``n_rows`` sets the table's
    row count in place of the image height: a rank's row slab under row-slab
    sharding (parallel/shard_step.py), whose ``pix`` are then slab-local."""
    H, W, S = n_rows or cfg.height, cfg.width, cfg.phd_pixel_table_slots
    n = H * W * S
    dest = torch.where(keep, torch.clamp(rank, max=S - 1) * (H * W) + pix, n).long()

    def scat(fill, vals, dtype):
        base = torch.full((n + 1,), fill, dtype=dtype, device=pix.device)
        base.index_copy_(0, dest, vals.to(dtype))
        return base[:n].view(S, H, W)

    dropped = ((pix < H * W) & ~keep).sum()
    meta = (track.to(torch.int32) << 8) | (forget.to(torch.int32) & 0xFF)
    return PixelTable(
        px=scat(0.0, px, torch.float32),
        py=scat(0.0, py, torch.float32),
        pz=scat(0.0, pz, torch.float32),
        weight=scat(0.0, weight, torch.float32),
        meta=scat(-1, meta, torch.int32),
        dropped=dropped,
    )


def window_half(R: int, H: int, W: int) -> int:
    """The stencils' half-width on an H x W image: ``R``, or max(H, W) - 1
    where ``R`` is larger.  From there on every window covers the whole
    image, and the offsets beyond it only meet the halo, whose terms are
    exact zeros (pass A: no weight; pass B: no valid observation), which
    change no sum: the result is the same bit for bit, for the plain
    stencils and the CUDA kernels alike."""
    return min(R, max(H, W) - 1)


def _pad_hw(a, r, fill):
    """Halo pad on the trailing (H, W) dims."""
    if a.dtype == torch.bool:
        return F.pad(a.to(torch.uint8), (r, r, r, r), value=int(fill)).to(torch.bool)
    return F.pad(a, (r, r, r, r), value=fill)


def pass_a_raw(
    cfg: MapConfig,
    params: FilterParams,
    px, py, pz, weff, trk,                    # [S, H, W]; weff = w * forgetting
    obs_x, obs_y, obs_z, inv_sigma, obs_trk,  # [H, W]
) -> torch.Tensor:
    """Raw per-pixel ck (before the valid mask, P_d and kappa), f32[H, W].
    Empty slots carry zero ``weff``."""
    S, H, W = px.shape
    R = window_half(cfg.neighbor_half, H, W)
    side = 2 * R + 1
    independent = params.if_use_independent_filter
    pad_px, pad_py, pad_pz = (_pad_hw(a, R, 0.0) for a in (px, py, pz))
    pad_w = _pad_hw(weff, R, 0.0)
    pad_trk = _pad_hw(trk, R, -1)
    ox, oy, oz = obs_x[None], obs_y[None], obs_z[None]
    isg, otrk = inv_sigma[None], obs_trk[None]

    ck = torch.zeros((H, W), dtype=torch.float32, device=px.device)
    for dm in range(side):
        for dn in range(side):
            win = lambda a: a[:, dm : dm + H, dn : dn + W]
            gk = gauss3(win(pad_px) - ox, win(pad_py) - oy, win(pad_pz) - oz, isg)
            w = win(pad_w)
            wtrk = win(pad_trk)
            if independent:
                contrib = torch.where(wtrk == otrk, w * gk, 0.0)
            else:
                gk = torch.where(wtrk != otrk, gk * params.id_transition_probability, gk)
                contrib = w * gk
            ck = ck + contrib.sum(dim=0)
    return ck


def pass_b_raw(
    cfg: MapConfig,
    params: FilterParams,
    px, py, pz,            # [S, H, W] particle positions
    trk_eff,               # [S, H, W] i32: track id, or -2 where the slot is empty
    ff_eff,                # [S, H, W] f32: forgetting factor, 0 where empty
    inv_sigma_p,           # [H, W] f32: 1/sigma at the particle's own pixel
    obs_x, obs_y, obs_z,   # [H, W]
    obs_valid,             # bool[H, W]
    obs_trk,               # i32[H, W]
    ck_kappa,              # f32[H, W]
):
    """Per table entry: (acc f32[S, H, W], right bool[S, H, W]).  ``right``
    is the "rightly updated" flag (same-track pdf > 0.1; always False under
    the independent filter).  Sigma is taken at the particle's own pixel
    (semantic_dsp_map.h:1047)."""
    S, H, W = px.shape
    R = window_half(cfg.neighbor_half, H, W)
    side = 2 * R + 1
    independent = params.if_use_independent_filter
    occupied = trk_eff != -2

    pad_ox, pad_oy, pad_oz = (_pad_hw(a, R, 0.0) for a in (obs_x, obs_y, obs_z))
    pad_ov = _pad_hw(obs_valid, R, False)
    pad_otrk = _pad_hw(obs_trk, R, -1)
    pad_ck = _pad_hw(ck_kappa, R, 1.0)
    isg = inv_sigma_p[None]

    acc = torch.zeros((S, H, W), dtype=torch.float32, device=px.device)
    right = torch.zeros((S, H, W), dtype=torch.bool, device=px.device)
    for dm in range(side):
        for dn in range(side):
            win = lambda a: a[dm : dm + H, dn : dn + W][None]
            gk_raw = gauss3(px - win(pad_ox), py - win(pad_oy), pz - win(pad_oz), isg)
            mask = occupied & win(pad_ov)
            same = win(pad_otrk) == trk_eff
            if independent:
                gk = torch.where(mask & same, gk_raw, 0.0)
            else:
                right = right | (mask & same & (gk_raw > MIN_RIGHTLY_UPDATED_PDF))
                gk = torch.where(same, gk_raw, gk_raw * params.id_transition_probability)
                gk = torch.where(mask, gk * ff_eff, 0.0)
            acc = acc + gk / win(pad_ck)
    return acc, right


def _obs_planes(cloud: LabeledCloud):
    """The observation x, y, z planes as contiguous [H, W] tensors."""
    return tuple(cloud.pos[..., i].contiguous() for i in range(3))


def _pass_a(cfg: MapConfig, params: FilterParams, t: PixelTable, cloud: LabeledCloud, raw):
    """Pass A around a raw ck function: ck_kappa f32[H, W]."""
    occupied = t.meta >= 0
    if params.if_use_independent_filter:
        weff = torch.where(occupied, t.weight, 0.0)
    else:
        ff = forgetting_factor(t.meta & 0xFF, params.forgetting_rate, params.max_forget_count)
        weff = torch.where(occupied, t.weight * ff, 0.0)
    inv_sigma = 1.0 / torch.clamp(cloud.sigma, min=1e-6)
    ox, oy, oz = _obs_planes(cloud)
    ck_raw = raw(
        cfg, params, t.px, t.py, t.pz, weff, t.meta >> 8, ox, oy, oz, inv_sigma, cloud.track,
    )
    ck = torch.where(cloud.valid, ck_raw, 0.0)
    return ck * params.detection_probability + params.noise_number


def _pass_b(cfg: MapConfig, params: FilterParams, t: PixelTable, cloud: LabeledCloud,
            ck_kappa, raw):
    """Pass B around a raw (acc, right) function: (new_weight f32,
    new_forget i32), both [S, H, W]."""
    occupied = t.meta >= 0
    forget_t = t.meta & 0xFF
    independent = params.if_use_independent_filter
    if independent:
        ff_eff = occupied.to(torch.float32)
    else:
        ff = forgetting_factor(forget_t, params.forgetting_rate, params.max_forget_count)
        ff_eff = torch.where(occupied, ff, 0.0)
    inv_sigma = 1.0 / torch.clamp(cloud.sigma, min=1e-6)
    trk_eff = torch.where(occupied, t.meta >> 8, -2)
    ox, oy, oz = _obs_planes(cloud)
    acc, right = raw(
        cfg, params, t.px, t.py, t.pz, trk_eff, ff_eff, inv_sigma,
        ox, oy, oz, cloud.valid, cloud.track, ck_kappa,
    )
    new_weight = t.weight * (
        acc * params.detection_probability + 1.0 - params.detection_probability
    )
    new_weight = torch.where(occupied, new_weight, t.weight)
    if independent:
        return new_weight, forget_t
    new_forget = torch.where(
        right,
        0,
        torch.where(forget_t < FORGET_COUNT_INCREMENT_CAP, forget_t + 1, forget_t),
    )
    return new_weight, new_forget


def stencil_pass_a(cfg: MapConfig, params: FilterParams, t: PixelTable, cloud: LabeledCloud):
    """Plain pass A on any device (the kernels' oracle): ck_kappa f32[H, W]."""
    return _pass_a(cfg, params, t, cloud, pass_a_raw)


def stencil_pass_b(cfg: MapConfig, params: FilterParams, t: PixelTable, cloud: LabeledCloud,
                   ck_kappa: torch.Tensor):
    """Plain pass B on any device (the kernels' oracle)."""
    return _pass_b(cfg, params, t, cloud, ck_kappa, pass_b_raw)


def stencil_pass_a_any(cfg: MapConfig, params: FilterParams, t: PixelTable, cloud: LabeledCloud):
    """Pass A: the plain stencil."""
    return stencil_pass_a(cfg, params, t, cloud)


def stencil_pass_b_any(cfg: MapConfig, params: FilterParams, t: PixelTable, cloud: LabeledCloud,
                       ck_kappa: torch.Tensor):
    """Pass B: the plain stencil."""
    return stencil_pass_b(cfg, params, t, cloud, ck_kappa)


def stencil_passes(cfg: MapConfig, params: FilterParams, t: PixelTable, cloud: LabeledCloud):
    """Both PHD passes: (ck_kappa f32[H,W], new_weight, new_forget [S,H,W])."""
    ck_kappa = stencil_pass_a_any(cfg, params, t, cloud)
    new_w, new_f = stencil_pass_b_any(cfg, params, t, cloud, ck_kappa)
    return ck_kappa, new_w, new_f
