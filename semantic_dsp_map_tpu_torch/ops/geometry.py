"""Small geometry helpers: quaternions, camera matrices, Gaussian pdf
(counterpart of ``semantic_dsp_map_tpu/ops/geometry.py``)."""

from __future__ import annotations

import torch

from ..config import (
    GAUSSIAN_PDF_COEF,
    GAUSSIAN_PDF_FLOOR,
    GAUSSIAN_PDF_Z_CLIP,
    MapConfig,
)
from ..state import constant


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r) for r in rows]).to(torch.float32)


def camera_matrices(cam_pos: torch.Tensor, cam_quat: torch.Tensor):
    """Camera pose -> (R_wc, t_wc, R_cw, t_cw); R_cw/t_cw is the extrinsic
    world -> camera map (semantic_dsp_map.h:744-747)."""
    r_wc = quat_to_rot(cam_quat)
    t_wc = cam_pos.to(torch.float32)
    r_cw = r_wc.T.contiguous()
    t_cw = -(r_cw @ t_wc)
    return r_wc, t_wc, r_cw, t_cw


def project_to_image(cfg: MapConfig, r_cw, t_cw, pos):
    """Pinhole projection of world points [..., 3] -> (row, col, cam_z, ok)
    with C truncation, depth-range and image-bounds gating
    (operations.h:1267-1290)."""
    cam = pos @ r_cw.T + t_cw
    return _project_cam(cfg, cam[..., 0], cam[..., 1], cam[..., 2])


def project_to_image_xyz(cfg: MapConfig, r_cw, t_cw, x, y, z):
    """project_to_image for component-separated coordinates."""
    cx = r_cw[0, 0] * x + r_cw[0, 1] * y + r_cw[0, 2] * z + t_cw[0]
    cy = r_cw[1, 0] * x + r_cw[1, 1] * y + r_cw[1, 2] * z + t_cw[1]
    cz = r_cw[2, 0] * x + r_cw[2, 1] * y + r_cw[2, 2] * z + t_cw[2]
    return _project_cam(cfg, cx, cy, cz)


def _project_cam(cfg: MapConfig, cx, cy, cz):
    in_depth = (cz >= cfg.depth_range_min) & (cz <= cfg.depth_range_max)
    zsafe = torch.where(cz == 0, torch.full_like(cz, 1e-6), cz)
    u = cfg.fx * cx / zsafe + cfg.cx
    v = cfg.fy * cy / zsafe + cfg.cy
    col = u.to(torch.int32)  # trunc toward zero, as static_cast<int>
    row = v.to(torch.int32)
    in_image = (row >= 0) & (row < cfg.height) & (col >= 0) & (col < cfg.width)
    return row, col, cz, in_depth & in_image


def gaussian_pdf1(x, mu, sigma):
    """The reference's per-axis "pdf": (1/sqrt(pi)) * exp(-z^2/2), floored
    to 1e-9 beyond |z| > 9.9 (basic_algorithms.h:417-422, 456-459)."""
    sigma = torch.clamp(sigma, min=1e-6)
    z = (x - mu) / sigma
    val = GAUSSIAN_PDF_COEF * torch.exp(-0.5 * z * z)
    return torch.where(z.abs() > GAUSSIAN_PDF_Z_CLIP, torch.full_like(val, GAUSSIAN_PDF_FLOOR), val)


def gaussian_pdf3(p, mu, sigma):
    """Product of the three per-axis pdfs (semantic_dsp_map.h:1016-1018)."""
    return (
        gaussian_pdf1(p[..., 0], mu[..., 0], sigma)
        * gaussian_pdf1(p[..., 1], mu[..., 1], sigma)
        * gaussian_pdf1(p[..., 2], mu[..., 2], sigma)
    )


def forgetting_factor(forget_count, forgetting_rate: float, max_forget_count: int):
    """getForgettingFactor (basic_algorithms.h:32-48): 2.5^(-n/rate) for
    n < max_forget_count else 0."""
    n = forget_count.to(torch.float32)
    # Divided by a tensor, not by the Python scalar: CUDA turns a division by
    # a scalar into a multiplication by its reciprocal, 1 ulp off the CPU's
    # and the JAX package's quotient at any rate other than a power of two.
    rate = constant(float(forgetting_rate), torch.float32, n.device)
    val = torch.pow(2.5, -n / rate)
    return torch.where(forget_count < max_forget_count, val, torch.zeros_like(val))
