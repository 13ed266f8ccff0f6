"""The comparison that decides ``correct``: what the program produced
against what the plain reference produced from the same inputs.

Each number covers one layer and is the worst over the frames compared:

- ``objects_gap``: the object table (``objects.py``).  1 where any row
  valid on either side differs in a discrete field (validity, track,
  label, counts, flags, stamps); otherwise the largest gap of a float field
  over those rows, |program - reference| / (1 + |reference|);
- ``store_parted``: the particle store, the voxel stamps, the scroll state
  and the clocks.  The share of slots whose status, label, track, stamp or
  forget counter differ (of voxels, for the voxel stamps); 1 where the
  scroll state or a clock differs;
- ``store_gap``: the largest |program - reference| of a slot's position
  (m) or weight, over the slots whose discrete fields agree and whose
  status is set;
- ``render_parted``: the render.  The share of voxels whose ``occ`` (as the
  program's copy on the host has it), ``label`` or ``track`` differ;
- ``wsum_gap``: the largest |program - reference| of a voxel's
  ``weight_sum``, over the voxels whose render and slots agree in every
  discrete field.

A NaN on one side only counts as a difference; NaN on both as agreement.
"""

from __future__ import annotations

import dataclasses

import torch

NUMBERS = ("objects_gap", "store_parted", "store_gap", "render_parted", "wsum_gap")

_SLOT_DISCRETE = ("status", "label", "track", "stamp", "forget")
_SLOT_FLOAT = ("px", "py", "pz", "weight")


def fields_of(obj):
    """A state (a dataclass of tensors, dataclasses and a generator) as a
    nested dictionary of the same tensors; a generator as its state."""
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if dataclasses.is_dataclass(obj):
        return {f.name: fields_of(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


def snapshot(obj, device=None):
    """``fields_of(obj)`` with every tensor copied (to ``device``, or where
    it is); the generator's state stays on the host."""
    def copy(key, x):
        if isinstance(x, dict):
            return {k: copy(k, v) for k, v in x.items()}
        return x.clone() if key == "rng" else x.to(device or x.device, copy=True)

    return copy(None, fields_of(obj))


def _differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: the two differ (NaN against NaN agrees)."""
    if a.is_floating_point():
        return (a != b) & ~(torch.isnan(a) & torch.isnan(b))
    return a != b


def _share(mask: torch.Tensor) -> float:
    return int(mask.sum()) / mask.numel()


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| with NaN on one side infinite and on both zero."""
    d = (a.double() - b.double()).abs()
    both = torch.isnan(a) & torch.isnan(b)
    return torch.where(both, torch.zeros_like(d), torch.nan_to_num(d, nan=float("inf")))


def objects_gap(prog: dict, ref: dict) -> float:
    rows = prog["valid"] | ref["valid"]
    if not bool(rows.any()):
        return 0.0
    worst = 0.0
    for name, p in prog.items():
        r = ref[name].to(p.device)
        if p.is_floating_point():
            d = _gap(p[rows], r[rows]) / (1.0 + r[rows].double().abs().nan_to_num(0.0))
            if d.numel():
                worst = max(worst, float(d.max()))
        elif bool(_differ(p[rows], r[rows]).any()):
            return 1.0
    return worst


def _state_parted(prog: dict, ref: dict) -> bool:
    """The scroll state or a clock differs."""
    for name, p in prog["scroll"].items():
        if bool(_differ(p, ref["scroll"][name].to(p.device)).any()):
            return True
    return any(bool(_differ(prog[n], ref[n].to(prog[n].device)).any())
               for n in ("global_time", "prev_frame_time"))


def _slots_parted(prog: dict, ref: dict) -> torch.Tensor:
    """Per slot: a discrete field differs."""
    pp, rp = prog["particles"], ref["particles"]
    parted = torch.zeros_like(pp["status"], dtype=torch.bool)
    for name in _SLOT_DISCRETE:
        parted |= _differ(pp[name], rp[name].to(pp[name].device))
    return parted


def store_parted(prog: dict, ref: dict, slots: torch.Tensor) -> float:
    if _state_parted(prog, ref):
        return 1.0
    vox = _differ(prog["voxel_stamp"], ref["voxel_stamp"].to(prog["voxel_stamp"].device))
    return max(_share(slots), _share(vox))


def store_gap(prog: dict, ref: dict, slots: torch.Tensor) -> float:
    pp, rp = prog["particles"], ref["particles"]
    same = (pp["status"] != 0) & ~slots
    if not bool(same.any()):
        return 0.0
    return max(float(_gap(pp[n][same], rp[n].to(pp[n].device)[same]).max()) for n in _SLOT_FLOAT)


def _voxels_parted(prog_out: dict, ref_out) -> torch.Tensor:
    dev = ref_out.occ.device
    parted = _differ(prog_out["occ"].to(dev), ref_out.occ)
    parted |= _differ(prog_out["label"].to(dev), ref_out.label)
    parted |= _differ(prog_out["track"].to(dev), ref_out.track)
    return parted


def wsum_gap(prog_out: dict, ref_out, voxels: torch.Tensor, slots: torch.Tensor) -> float:
    """Over the voxels whose render and slots agree in every discrete
    field (a voxel that parts there is ``render_parted``'s or
    ``store_parted``'s)."""
    dev = ref_out.weight_sum.device
    V = voxels.numel()
    same = ~voxels & ~slots.to(dev).view(V, -1).any(dim=1)
    if not bool(same.any()):
        return 0.0
    return float(_gap(prog_out["weight_sum"].to(dev)[same], ref_out.weight_sum[same]).max())


def compare(prog_state: dict, prog_out: dict, ref_state, ref_out) -> dict:
    """The numbers of one frame: ``prog_state`` the program's state after
    it (``snapshot``), ``prog_out`` its render (``occ`` the host copy,
    ``label``, ``track``, ``weight_sum``); ``ref_state`` and ``ref_out`` the
    reference's MapState and RenderResult after the same frame."""
    ref = fields_of(ref_state)
    slots = _slots_parted(prog_state, ref)
    voxels = _voxels_parted(prog_out, ref_out)
    return {
        "objects_gap": objects_gap(prog_state["objects"], ref["objects"]),
        "store_parted": store_parted(prog_state, ref, slots),
        "store_gap": store_gap(prog_state, ref, slots),
        "render_parted": _share(voxels),
        "wsum_gap": wsum_gap(prog_out, ref_out, voxels, slots),
    }


def worst(readings: list) -> dict:
    """Each number's largest reading over the frames compared."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a NaN is over)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
