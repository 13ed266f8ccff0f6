"""The bytes two frame kernels need on a state, and the bound they set:
frozen copies of ``chip_smoke.py``'s ``render_census`` and ``front_bound``
(counts only: the writes that depend on the frame, the clamped weights and
the collected statuses, are left out, so the bound is a lower one).

A bound is the least time the card could take: the bytes over the
published HBM rate of one H100 (SXM, 3.35 TB/s at its 700 W limit).
"""

from __future__ import annotations

import torch

#: Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12


def bound_ms(n_bytes: float) -> float:
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def slot_counts(status: torch.Tensor, stamp: torch.Tensor, vax: torch.Tensor, K: int):
    """(slots with a status set, slots alive) of a store: a slot is alive
    where its status is set and its stamp is not older than its voxel's
    scroll stamp."""
    has_status = status != 0
    alive = has_status & (stamp.view(-1, K) >= vax[:, None]).view(-1)
    return int(has_status.sum()), int(alive.sum())


def render_bytes(V: int, K: int, with_status: int, alive: int) -> int:
    """The render's bytes: every slot's status (1 B), the per-voxel scroll
    and observation stamps (4 B each), the four results (4 B each a voxel),
    the stamp (4 B) of the slots with a status, weight, track and label
    (9 B) of the alive ones."""
    return V * K + 2 * 4 * V + 4 * 4 * V + 4 * with_status + 9 * alive


def front_bytes(V: int, K: int, with_status: int, alive: int) -> int:
    """The candidate scan's bytes: every slot's status, the scroll stamps,
    the pose (a 3 x 3 rotation and a translation, f32), the two u8 outputs a
    voxel; the stamp of the slots with a status and the position (12 B) of
    the alive ones."""
    return V * K + 4 * V + 4 * 12 + 2 * V + 4 * with_status + 12 * alive


def census(status, stamp, vax, V: int, K: int) -> dict:
    """Both kernels' bytes and bounds on one store."""
    with_status, alive = slot_counts(status, stamp, vax, K)
    rb, fb = render_bytes(V, K, with_status, alive), front_bytes(V, K, with_status, alive)
    return {"with_status": with_status, "alive": alive, "render_bytes": rb,
            "front_bytes": fb, "render_bound_ms": bound_ms(rb), "front_bound_ms": bound_ms(fb)}
