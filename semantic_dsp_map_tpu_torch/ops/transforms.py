"""Rigid transform estimation: masked Kabsch/SVD fit and batched RANSAC
(counterpart of ``semantic_dsp_map_tpu/ops/transforms.py``;
basic_algorithms.h:56-195).  All functions broadcast over leading batch
dimensions, so the object layer runs every instance in one call."""

from __future__ import annotations

import torch


def _eye4(shape, device):
    return torch.eye(4, dtype=torch.float32, device=device).expand(*shape, 4, 4)


def _compose(R, t):
    T = _eye4(R.shape[:-2], R.device).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def kabsch(P, Q, mask):
    """Masked rigid fit Q ~ R @ P + t (basic_algorithms.h:56-95).
    P, Q: f32[..., N, 3]; mask: bool[..., N].  Returns (T [..., 4, 4], ok)."""
    m = mask.to(torch.float32)[..., None]
    cnt = torch.clamp(m.sum(dim=-2), min=1e-9)
    cp = (P * m).sum(dim=-2) / cnt
    cq = (Q * m).sum(dim=-2) / cnt
    Pc = (P - cp[..., None, :]) * m
    Qc = (Q - cq[..., None, :]) * m
    H = torch.einsum("...ni,...nj->...ij", Pc, Qc)
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    R = V @ U.transpose(-1, -2)
    det = torch.linalg.det(R)
    # Reflection fix: flip the third column of V (basic_algorithms.h:81-84).
    flip = torch.ones_like(V)
    flip[..., :, 2] = torch.where(det < 0, -1.0, 1.0)[..., None]
    R = (V * flip) @ U.transpose(-1, -2)
    t = cq - torch.einsum("...ij,...j->...i", R, cp)
    return _compose(R, t), mask.sum(dim=-1) >= 3


def apply_transform(T, pts):
    """T[..., 4, 4] applied to pts[..., N, 3]."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]


def _normalize(v, eps=1e-12):
    return v / torch.sqrt((v * v).sum(dim=-1, keepdim=True) + eps)


def _triangle_frame(p1, p2, p3):
    """Orthonormal frame of a point triple (Gram-Schmidt on the edges)."""
    e1 = _normalize(p2 - p1)
    u = p3 - p1
    e2 = _normalize(u - (u * e1).sum(dim=-1, keepdim=True) * e1)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)


def triangle_fit(Ps, Qs):
    """Closed-form rigid fit of 3-point correspondences (the RANSAC
    hypotheses).  Ps, Qs: f32[..., 3, 3].  Degenerate triples give the
    identity."""
    Fp = _triangle_frame(Ps[..., 0, :], Ps[..., 1, :], Ps[..., 2, :])
    Fq = _triangle_frame(Qs[..., 0, :], Qs[..., 1, :], Qs[..., 2, :])
    R = Fq @ Fp.transpose(-1, -2)
    cp = Ps.mean(dim=-2)
    cq = Qs.mean(dim=-2)
    t = cq - torch.einsum("...ij,...j->...i", R, cp)
    T = _compose(R, t)
    ok = torch.isfinite(T.reshape(T.shape[:-2] + (16,))).all(dim=-1)
    return torch.where(ok[..., None, None], T, _eye4(T.shape[:-2], T.device))


def ransac_transform(gumbel, P, Q, mask, threshold: float, refit_with_inliers: bool):
    """estimateTransformationRANSAC (basic_algorithms.h:106-195), batched.

    ``gumbel`` f32[..., n_iter, N] holds the Gumbel draws that pick each
    hypothesis's distinct random triple (Gumbel top-3 over the valid
    points); the caller draws them from its generator.  P, Q: f32[..., N, 3];
    mask: bool[..., N].  Returns (T, inlier_mask, n_inliers, mse,
    first_inlier_idx)."""
    batch = P.shape[:-2]
    n_iter, N = gumbel.shape[-2:]
    P, Q = P.reshape(-1, N, 3), Q.reshape(-1, N, 3)
    mask = mask.reshape(-1, N)
    B = P.shape[0]
    bi = torch.arange(B, device=P.device)

    g = torch.where(mask[:, None, :], gumbel.reshape(B, n_iter, N), float("-inf"))
    triple = torch.topk(g, 3, dim=-1).indices              # [B, n_iter, 3]
    T_h = triangle_fit(P[bi[:, None, None], triple], Q[bi[:, None, None], triple])

    Pt = apply_transform(T_h, P[:, None].expand(B, n_iter, N, 3))
    err = torch.linalg.vector_norm(Pt - Q[:, None], dim=-1)
    inl = mask[:, None, :] & (err < threshold)
    counts = inl.sum(dim=-1)

    best = torch.argmax(counts, dim=-1)                    # first max wins
    best_T, best_inl, n_inl = T_h[bi, best], inl[bi, best], counts[bi, best]

    if refit_with_inliers:
        refit_T, refit_ok = kabsch(P, Q, best_inl)
        use_refit = refit_ok & (n_inl >= 3)
        best_T = torch.where(use_refit[..., None, None], refit_T, best_T)

    Pf = apply_transform(best_T, P)
    sq = ((Pf - Q) ** 2).sum(dim=-1)
    mse = torch.where(best_inl, sq, 0.0).sum(dim=-1) / torch.clamp(n_inl, min=1)

    first_inlier = torch.argmax(best_inl.to(torch.int32), dim=-1)
    first_inlier = torch.where(best_inl.any(dim=-1), first_inlier, 0)
    return (
        best_T.reshape(batch + (4, 4)), best_inl.reshape(batch + (N,)),
        n_inl.reshape(batch), mse.reshape(batch), first_inlier.reshape(batch),
    )
