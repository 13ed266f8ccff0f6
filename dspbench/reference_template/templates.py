"""The template stages, plain: the template bank read from ``.pcd`` files,
the hypothesis sweep, the gate, template rematch and template birth.

After the reference's ``findBestTemplateTransformationPHD`` and its
free-space variant (pointcloud_tools.h:686-865, 874-1097),
``alignTemplatesToPointCloud`` (:333-360), the rematch of objects flagged
``to_match_previous`` (semantic_dsp_map.h:616-669) and the birth of
GUESSED_BORN particles on a matched car (:806-894).  Each stage reads its
gate to the host and loops over the rows in Python; the sweep loops over
the 36 yaws and 9 jitters one hypothesis at a time.

What the program holds fixed and this module holds fixed with it, so that
the same inputs give the same answers: the match grid (64 cells of 0.2 m an
axis, anchored at the source's lower corner less the free-space margin;
points outside it hit nothing), at most 8,192 source points, 4,096 template
points and 192 ray samples; the free space of a ray ends at the first
occupied cell of the whole source cloud (the C++ marks and casts point by
point); the yaw table's cosines and sines rounded once from double; each
rotated point as ``(r0 * x + r1 * y) + r2 * z`` in float32 and every
division by a tensor; at most two rematches and one template birth a frame,
in ascending object row.
"""

from __future__ import annotations

import math
import os
from typing import List, NamedTuple

import numpy as np
import torch

from ..reference.config import PARTICLE_OCC_INIT_WEIGHT
from ..reference.ops import codecs
from ..reference.ops.birth import Candidates, _insert_core
from ..reference.ops.blocks import block_layout
from ..reference.state import STATUS_GUESSED_BORN, STATUS_INVALID

VOXEL = 0.2             # match-grid cell (pointcloud_tools.h:740, :928)
EXPAND = 10             # free-space margin in cells a side (:935)
PUSH = 10.0             # the template is pushed 10 m past the closest point (:774)
ANGLES = 36             # yaw 0..350 degrees, step 10 (:771)
NOISE_RANGE = 1         # translation jitter, cells (:806)
GRID_N = 64             # match-grid cells an axis
MAX_SOURCE = 8192       # source points a sweep takes
MAX_TEMPLATE = 4096     # template points a template holds
RAY_STEPS = 192         # samples a ray, 0.2 m apart
MIN_POINTS, MAX_POINTS, MIN_BBOX_MM = 1500, 8000, 1000  # birth gate (semantic_dsp_map.h:820-828)
REMATCH_MIN_POINTS = 100                                 # rematch gate (:641-643)
COPIES, JITTER_SIGMA = 3, 0.01                           # guessed copies a point (:878-891)
MATCHED_WEIGHT = 0.2    # rematched particles' weight (operations.h:136)
RM_MAX, TB_MAX = 2, 1   # rematches and template births a frame
INSERT_BLOCKS = 256     # target blocks of each stage's insert
PARTICLE_MIN_WEIGHT = 0.1  # getParticlesAsPointCloud's threshold (operations.h:242-255)


# ---------------------------------------------------------------------------
# The template bank
# ---------------------------------------------------------------------------

_PCD_TYPES = {("F", 4): "<f4", ("F", 8): "<f8", ("I", 1): "<i1", ("I", 2): "<i2",
              ("I", 4): "<i4", ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4"}


def read_pcd(path: str) -> np.ndarray:
    """The x, y, z of a PCD file (``DATA ascii`` or ``binary``) as
    float32[N, 3]."""
    header = {}
    with open(path, "rb") as f:
        while "DATA" not in header:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no DATA line")
            words = line.decode("ascii", "replace").split()
            if words and not words[0].startswith("#"):
                header[words[0].upper()] = words[1:]
        body = f.read()
    fields = header["FIELDS"]
    counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
    dtype = np.dtype([(name, _PCD_TYPES[t, int(s)], (c,)) if c > 1 else
                      (name, _PCD_TYPES[t, int(s)])
                      for name, s, t, c in zip(fields, header["SIZE"], header["TYPE"], counts)])
    n = int(header["POINTS"][0])
    mode = header["DATA"][0].lower()
    if mode == "binary":
        rows = np.frombuffer(body, dtype=dtype, count=n)
        return np.stack([rows[a].astype(np.float32) for a in "xyz"], axis=-1)
    if mode == "ascii":
        table = np.array([r.split() for r in body.decode("ascii").splitlines() if r.strip()][:n],
                         dtype=np.float64)
        at = {name: sum(counts[:i]) for i, name in enumerate(fields)}
        return np.stack([table[:, at[a]] for a in "xyz"], axis=-1).astype(np.float32)
    raise ValueError(f"{path}: DATA {mode} is not read here")


def read_bank(folder: str, label_id: int) -> List[np.ndarray]:
    """The templates of ``label_id`` under ``folder`` (a template's label id
    is its directory's name; files in sorted path order), each centred on
    its range's midpoint (alignPointCloudToXYZCenter, pointcloud_tools.h:
    365-380) and cut to MAX_TEMPLATE points by an even stride."""
    paths = sorted(os.path.join(root, name) for root, _dirs, files in os.walk(folder)
                   for name in files if name.endswith(".pcd"))
    out = []
    for path in paths:
        if int(os.path.basename(os.path.dirname(path))) != label_id:
            continue
        pts = read_pcd(path)
        pts = pts - (pts.min(axis=0) + pts.max(axis=0)) * np.float32(0.5)
        if len(pts) > MAX_TEMPLATE:
            pts = pts[np.linspace(0, len(pts) - 1, MAX_TEMPLATE).astype(np.int64)]
        out.append(pts.astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------


def _yaw_table() -> np.ndarray:
    """f32[36, 3, 3]: the yaw rotations about +y, cosine and sine of each
    float32 angle rounded once from double."""
    out = np.zeros((ANGLES, 3, 3), np.float32)
    for a in range(ANGLES):
        angle = np.float64(np.float32(a) * np.float32(10.0 * math.pi / 180.0))
        c, s = np.float32(np.cos(angle)), np.float32(np.sin(angle))
        out[a] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    return out


def _jitters() -> list:
    """The 9 translation jitters, x outer and y inner (pointcloud_tools.h:
    806-809)."""
    steps = [np.float32(i) * np.float32(VOXEL) for i in range(-NOISE_RANGE, NOISE_RANGE + 1)]
    return [np.array([jx, jy, 0.0], np.float32) for jx in steps for jy in steps]


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def _rotate(R: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return torch.stack([R[i, 0] * x + R[i, 1] * y + R[i, 2] * z for i in range(3)], dim=-1)


def _cells(pts: torch.Tensor, origin: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """The flat match-grid cell of each point, -1 where it lies outside
    (the index truncated toward zero, as the C++'s int casts)."""
    rel = (pts - origin) / vs
    idx = rel.clamp(-1.0, float(GRID_N)).to(torch.int32)
    inside = ((rel >= 0) & (idx < GRID_N)).all(dim=-1)
    flat = (idx[:, 0].long() * GRID_N + idx[:, 1].long()) * GRID_N + idx[:, 2].long()
    return torch.where(inside, flat, -1)


class Source(NamedTuple):
    closest: torch.Tensor   # f32[3] the source point nearest the camera
    push: torch.Tensor      # f32[3]
    origin: torch.Tensor    # f32[3] the grid's lower corner
    occupied: torch.Tensor  # i64[n] the occupied cells, sorted
    free: torch.Tensor      # i64[m] the observed-free cells, sorted


def prepare_source(src: torch.Tensor, cam: torch.Tensor, free_space: bool) -> Source:
    """The source cloud's grid (``src``: its points, at most MAX_SOURCE):
    occupied cells and, with ``free_space``, the cells the camera's rays to
    the points cross before their first occupied cell."""
    dev = src.device
    vs = _f32(VOXEL, dev)
    d2 = _sq_norm(src - cam)
    closest = src[int(torch.argmin(d2))]
    origin = src.amin(dim=0) - _f32(EXPAND * VOXEL if free_space else 0.0, dev)
    cells = _cells(src, origin, vs)
    occupied = torch.unique(cells[cells >= 0])
    free = occupied[:0]
    if free_space:
        is_occ = torch.zeros(GRID_N ** 3, dtype=torch.bool, device=dev)
        is_occ[occupied] = True
        ks = torch.arange(RAY_STEPS, dtype=torch.float32, device=dev) * _f32(VOXEL, dev)
        marked = []
        for chunk in torch.split(src, 1024):
            ray = chunk - cam
            length = torch.sqrt(_sq_norm(ray))
            direction = ray / torch.clamp(length, min=1e-6)[:, None]
            samples = cam + direction[:, None, :] * ks[None, :, None]        # [n, S, 3]
            c = _cells(samples.reshape(-1, 3), origin, vs).view(len(chunk), RAY_STEPS)
            hits = (c >= 0) & is_occ[c.clamp(min=0)]
            # A ray stops at its first occupied cell, which stays unmarked.
            first = torch.where(hits.any(dim=1), hits.int().argmax(dim=1), RAY_STEPS)
            k = torch.arange(RAY_STEPS, device=dev)[None, :]
            keep = (k < first[:, None]) & (ks[None, :] < length[:, None])
            keep &= (length > 1e-6)[:, None] & (c >= 0)
            marked.append(c[keep])
        free = torch.unique(torch.cat(marked))
        free = free[~is_occ[free]]
    to_closest = closest - cam
    push = to_closest / torch.clamp(torch.sqrt(_sq_norm(to_closest)), min=1e-6) * _f32(PUSH, dev)
    return Source(closest, push, origin, occupied, free)


def sweep(s: Source, tpl: torch.Tensor):
    """Every hypothesis of the template ``tpl`` (its points, centred)
    against the source: (score f32, aligned f32[len(tpl), 3]).  A
    hypothesis scores the occupied cells its points hit less the free cells
    they hit; the first best in the order yaw, jitter x, jitter y wins
    (the C++'s strict ``>``); the score is its count over the occupied
    cells'."""
    dev = tpl.device
    vs = _f32(VOXEL, dev)
    yaw = torch.from_numpy(_yaw_table()).to(dev)
    jitters = [torch.from_numpy(j).to(dev) for j in _jitters()]
    is_occ = torch.zeros(GRID_N ** 3, dtype=torch.bool, device=dev)
    is_occ[s.occupied] = True
    is_free = torch.zeros(GRID_N ** 3, dtype=torch.bool, device=dev)
    is_free[s.free] = True
    best, best_move, best_R = None, None, None
    for a in range(ANGLES):
        rot = _rotate(yaw[a], tpl) + s.push
        correct = s.closest - rot[int(torch.argmin(_sq_norm(rot)))]
        for j in jitters:
            cells = _cells(rot + (correct + j), s.origin, vs)
            hit = torch.unique(cells[cells >= 0])
            score = int(is_occ[hit].sum()) - int(is_free[hit].sum())
            if best is None or score > best:
                best, best_move, best_R = score, s.push + correct + j, yaw[a]
    aligned = _rotate(best_R, tpl) + best_move
    score = _f32(float(best), dev) / _f32(float(max(len(s.occupied), 1)), dev)
    return score, aligned


# ---------------------------------------------------------------------------
# The stages
# ---------------------------------------------------------------------------


class GateRow(NamedTuple):
    row: int
    track: int
    label: int
    count: int       # the track's valid cloud points (uncapped)
    extent_mm: tuple  # the x and y extents of those points, mm, truncated


def gate(objects, cloud, row: int) -> GateRow:
    """What the stages ask of object ``row``: its cloud points' count and
    their bounding box's x and y extents (getBoundingBox,
    semantic_dsp_map.h:1388-1412)."""
    track = int(objects.track_id[row])
    mine = (cloud.track.reshape(-1) == track) & cloud.valid.reshape(-1)
    n = int(mine.sum())
    ext = (0, 0)
    if n:
        pos = cloud.pos.reshape(-1, 3)[mine]
        ext = tuple(int(((pos[:, i].amax() - pos[:, i].amin()) * 1000.0).to(torch.int32))
                    for i in (0, 1))
    return GateRow(row, track, int(objects.label[row]), n, ext)


def track_points(cloud, track: int) -> torch.Tensor:
    """The track's valid cloud points in pixel order, the first MAX_SOURCE."""
    mine = (cloud.track.reshape(-1) == track) & cloud.valid.reshape(-1)
    return cloud.pos.reshape(-1, 3)[mine][:MAX_SOURCE]


def particle_points(cfg, particles, scroll, track: int) -> tuple:
    """getParticlesAsPointCloud (operations.h:242-255) of ``track``: its
    alive particles of weight over PARTICLE_MIN_WEIGHT in store order, from
    the first ``max_moving_blocks`` storage blocks that hold any, the first
    MAX_TEMPLATE of them; and how many the store holds in all."""
    V, K = cfg.num_voxels, cfg.slots_per_voxel
    _bv, nb, spb = block_layout(cfg)
    alive = codecs.particle_alive(particles.status.view(V, K), particles.stamp.view(V, K),
                                  codecs.axis_stamps_per_voxel(cfg, scroll)).reshape(-1)
    mine = alive & (particles.track == track) & (particles.weight > _f32(PARTICLE_MIN_WEIGHT,
                                                                         particles.weight.device))
    slots = torch.nonzero(mine).reshape(-1)
    blocks = torch.unique(slots // spb)[:min(cfg.max_moving_blocks, nb)]
    slots = slots[torch.isin(slots // spb, blocks)][:MAX_TEMPLATE]
    pts = torch.stack([particles.px[slots], particles.py[slots], particles.pz[slots]], dim=-1)
    return pts, int(mine.sum())


def _candidates(pos, track, label, weight, gt) -> Candidates:
    n, dev = len(pos), pos.device
    full = lambda v: torch.full((n,), v, dtype=torch.int32, device=dev)
    return Candidates(pos=pos, weight=torch.full((n,), weight, dtype=torch.float32, device=dev),
                      label=torch.cat(label), track=torch.cat(track),
                      status=full(STATUS_GUESSED_BORN), stamp=gt.to(torch.int32).expand(n),
                      forget=full(0), priority=torch.arange(n, dtype=torch.int32, device=dev),
                      valid=torch.ones(n, dtype=torch.bool, device=dev))


def _insert(cfg, particles, scroll, pieces, weight, gt):
    """One insert of every slot's particles (``pieces``: (positions, track,
    label) a slot, in slot order); the store as it was where none has any.
    Returns (particles, accepted count)."""
    pieces = [p for p in pieces if len(p[0])]
    if not pieces:
        return particles, 0
    dev = pieces[0][0].device
    ids = lambda v, n: torch.full((n,), v, dtype=torch.int32, device=dev)
    cand = _candidates(torch.cat([p[0] for p in pieces]),
                       [ids(p[1], len(p[0])) for p in pieces],
                       [ids(p[2], len(p[0])) for p in pieces], weight, gt)
    res = _insert_core(cfg, particles, scroll, cand, resample_targets=False,
                       max_target_blocks=INSERT_BLOCKS)
    return res.particles, int(res.accepted_count)


def rematch(cfg, params, particles, scroll, objects, cloud, cam, gt):
    """Template rematch (semantic_dsp_map.h:616-669): each of the first
    RM_MAX rows of a valid, moving object with a moved record flagged
    ``to_match_previous`` that shows at least REMATCH_MIN_POINTS cloud
    points has its particles' cloud swept against the observed one; on a
    score over the threshold with particles to move, the track's particles
    are deleted and the aligned cloud inserted at MATCHED_WEIGHT.  Every
    slot sweeps before any deletes.  Returns (particles, sweeps)."""
    wanted = objects.valid & objects.to_match_previous & objects.moving & objects.has_moved_record
    rows = torch.nonzero(wanted).reshape(-1).tolist()[:RM_MAX]
    matched, sweeps = [], 0
    for row in rows:
        g = gate(objects, cloud, row)
        if g.count < REMATCH_MIN_POINTS:
            continue
        sweeps += 1
        pts, in_store = particle_points(cfg, particles, scroll, g.track)
        if not len(pts):  # nothing to move: no match
            continue
        pts = pts - (pts.amin(dim=0) + pts.amax(dim=0)) * 0.5
        src = track_points(cloud, g.track)
        score, aligned = sweep(prepare_source(src, cam, free_space=False), pts)
        if bool(score > _f32(params.match_score_threshold, cam.device)) and in_store > 0:
            matched.append((aligned, g.track, g.label))
    for _aligned, track, _label in matched:
        particles.status[particles.track == track] = STATUS_INVALID
    particles, _ = _insert(cfg, particles, scroll, matched, MATCHED_WEIGHT, gt)
    return particles, sweeps


def template_birth(cfg, params, particles, scroll, objects, cloud, cam, gt, bank, car_label,
                   generator):
    """Template birth (semantic_dsp_map.h:806-894): the first TB_MAX rows
    of valid Car objects flagged ``to_match_templates``; a row whose cloud
    holds more than MIN_POINTS and fewer than MAX_POINTS points with x and
    y extents of at least 1 m is swept (free space considered) against
    every template of the bank, and the best template's score decides: at
    or over the threshold the flag clears and COPIES jittered GUESSED_BORN
    particles are born a template point; under it the flag stays and the
    row is tried again next frame.  The jitter is drawn from ``generator``
    every frame, whether a row is swept or not.  Returns (particles,
    objects' new ``to_match_templates``, sweeps, guessed particles
    accepted)."""
    flags = objects.to_match_templates.clone()
    if not bank:
        return particles, flags, 0, 0
    dev = cam.device
    normals = torch.randn((TB_MAX * MAX_TEMPLATE * COPIES, 3), generator=generator, device=dev)
    wanted = objects.valid & objects.to_match_templates & (objects.label == car_label)
    rows = torch.nonzero(wanted).reshape(-1).tolist()[:TB_MAX]
    born, sweeps = [], 0
    thr = _f32(params.match_score_threshold, dev)
    for slot, row in enumerate(rows):
        g = gate(objects, cloud, row)
        if not (MIN_POINTS < g.count < MAX_POINTS and min(g.extent_mm) >= MIN_BBOX_MM):
            continue
        sweeps += 1
        s = prepare_source(track_points(cloud, g.track), cam, free_space=True)
        best_score, best_aligned, best_n = None, None, 0
        for tpl in bank:
            score, aligned = sweep(s, tpl)
            if best_score is None or bool(score > best_score):
                best_score, best_aligned, best_n = score, aligned, len(tpl)
        flags[row] = bool(best_score < thr)
        if bool(best_score >= thr):
            base = slot * MAX_TEMPLATE * COPIES
            jitter = normals[base:base + best_n * COPIES] * _f32(JITTER_SIGMA, dev)
            born.append((torch.repeat_interleave(best_aligned, COPIES, dim=0) + jitter,
                         g.track, g.label))
    particles, accepted = _insert(cfg, particles, scroll, born, PARTICLE_OCC_INIT_WEIGHT, gt)
    return particles, flags, sweeps, accepted


def load_bank(folder: str, car_label: int, device) -> List[torch.Tensor]:
    return [torch.from_numpy(t).to(device) for t in read_bank(folder, car_label)]

