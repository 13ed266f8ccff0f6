"""CAD-template matching: the "guessed" particle birth subsystem
(counterpart of ``semantic_dsp_map_tpu/ops/templates.py``; reference
pointcloud_tools.h:318-1097).

  - ``findBestTemplateTransformationPHD`` / ``...FSConsidered``: sweep 36 yaw
    angles x 3x3 translation jitters of a template cloud against a voxelized
    source cloud; score = (unique source-occupied voxels hit) minus, in the
    FS variant, (unique observed-free voxels hit), over the source's
    occupied-voxel count (pointcloud_tools.h:686-865, 874-1097).
  - ``alignTemplatesToPointCloud``: best template of a label by that score
    (pointcloud_tools.h:333-360).

All 324 hypotheses of a template are evaluated at once: the transformed
points of every (angle, jitter) pair are snapped to a static match grid and
scattered into one boolean hit bitmap ``[A*J, cells + 1]`` (the last column
is the drop cell of out-of-grid and padding points), which dedups the
voxels each hypothesis hits.  Ties keep the first hypothesis in the
reference's order: angle outer, jitter x, then jitter y.

Cell truncation decides the score, so the arithmetic is kept the same on
every device: the 36-angle cos/sin table is built once on the host in f32,
rotations are evaluated row by row (``r0*x + r1*y + r2*z``, then the push)
as separate f32 ops, and divisions take a device tensor (PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal instead).

Deliberate deviation of the JAX package, kept: the FS variant's rays are
blocked by the complete occupied set (order-independent), where the
reference interleaves "mark occupied" and "cast ray" per point.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..state import constant

#: Match-grid voxel size (pointcloud_tools.h:740 / :928: voxel_size = 0.2f).
TM_VOXEL_SIZE = 0.2

#: FS-variant grid expansion in voxels per side (pointcloud_tools.h:935).
TM_EXPAND = 10

#: The template is pushed 10 m past the closest point before snapping
#: (pointcloud_tools.h:774: "the object's half size is no more than 10").
TM_PUSH_DISTANCE = 10.0

#: Yaw sweep: 0..350 degrees step 10 (pointcloud_tools.h:771).
TM_NUM_ANGLES = 36

#: Translation jitter offsets in grid voxels (pointcloud_tools.h:806).
TM_NOISE_RANGE = 1

#: Gaussian noise sigma for guessed-particle birth (semantic_dsp_map.h:884).
GUESSED_BIRTH_NOISE = 0.01

#: Guessed particles per aligned template point (semantic_dsp_map.h:880).
GUESSED_BIRTH_COPIES = 3

#: Particle weight for re-matched particles (operations.h:136).
MATCHED_WEIGHT = 0.2

#: Eligibility for template birth (semantic_dsp_map.h:820-828): Car-labeled,
#: point count in (1500, 8000), bbox x/y extents >= 1 m.
TM_MIN_POINTS = 1500
TM_MAX_POINTS = 8000
TM_MIN_BBOX_XY = 1.0

#: Rematch path needs >= 100 observed points (semantic_dsp_map.h:641-643).
REMATCH_MIN_POINTS = 100

_BIG = 3.4e38


@dataclasses.dataclass(frozen=True)
class MatchGridConfig:
    """Static shape of the match grid, anchored at (source bbox_min -
    expand).  64 voxels/axis @ 0.2 m = 12.8 m span, >= any <= 8 m vehicle
    + 2 m slack + the FS expansion."""

    grid_n: int = 64
    max_source_points: int = 8192
    max_template_points: int = 4096
    fs_ray_steps: int = 192  # 38.4 m of ray @ 0.2 m steps

    @property
    def num_cells(self) -> int:
        return self.grid_n ** 3


class MatchResult(NamedTuple):
    score: torch.Tensor    # f32: biggest_intersection / occupied_voxel_count
    tmatrix: torch.Tensor  # f32[4, 4] template -> world
    aligned: torch.Tensor  # f32[P, 3] transformed template points


def center_cloud(pts: np.ndarray) -> np.ndarray:
    """alignPointCloudToXYZCenter (pointcloud_tools.h:365-380): subtract the
    min/max range center per axis."""
    c = (pts.min(axis=0) + pts.max(axis=0)) * 0.5
    return pts - c


@dataclasses.dataclass
class TemplateBank:
    """Padded CAD templates grouped by label id (the reference's
    ``existing_point_cloud_templates_map_``, pointcloud_tools.h:482)."""

    pts: np.ndarray       # f32[T, P, 3] centered template points
    valid: np.ndarray     # bool[T, P]
    label: np.ndarray     # i32[T]

    @staticmethod
    def from_folder(folder: str, cfg: MatchGridConfig) -> "TemplateBank":
        """setTemplatePath + readExistingPointCloudTemplates
        (pointcloud_tools.h:382-420): each .pcd's label id is its parent
        directory name; templates are centered on load."""
        from ..io import read_template_folder

        return TemplateBank.from_dict(read_template_folder(folder), cfg)

    @staticmethod
    def from_dict(tpls: Dict[int, List[np.ndarray]], cfg: MatchGridConfig) -> "TemplateBank":
        P = cfg.max_template_points
        rows, valids, labels = [], [], []
        for label_id in sorted(tpls):
            for cloud in tpls[label_id]:
                cloud = center_cloud(np.asarray(cloud, np.float32))
                if cloud.shape[0] > P:
                    # Deterministic stride subsample to the static capacity.
                    idx = np.linspace(0, cloud.shape[0] - 1, P).astype(np.int64)
                    cloud = cloud[idx]
                pad = np.zeros((P, 3), np.float32)
                pad[: cloud.shape[0]] = cloud
                v = np.zeros(P, bool)
                v[: cloud.shape[0]] = True
                rows.append(pad)
                valids.append(v)
                labels.append(label_id)
        if not rows:
            rows = [np.zeros((P, 3), np.float32)]
            valids = [np.zeros(P, bool)]
            labels = [-1]
        return TemplateBank(
            pts=np.stack(rows), valid=np.stack(valids), label=np.asarray(labels, np.int32)
        )

    def of_label(self, label_id: int):
        sel = np.nonzero(self.label == label_id)[0]
        return self.pts[sel], self.valid[sel]


# ---------------------------------------------------------------------------
# The hypothesis sweep
# ---------------------------------------------------------------------------


def _host_tables():
    """(R f32[A, 3, 3], jitter f32[J, 3]) built on the host in f32.

    Yaw about +y (Eigen AngleAxisf(angle, UnitY), pointcloud_tools.h:779);
    cos/sin of each f32 angle are rounded once from double.  Jitter order is
    x outer, y inner (pointcloud_tools.h:806-809)."""
    ang = np.arange(TM_NUM_ANGLES, dtype=np.float32) * np.float32(10.0 * np.pi / 180.0)
    ca = np.cos(ang.astype(np.float64)).astype(np.float32)
    sa = np.sin(ang.astype(np.float64)).astype(np.float32)
    zeros, ones = np.zeros_like(ca), np.ones_like(ca)
    R = np.stack(
        [np.stack([ca, zeros, sa], -1), np.stack([zeros, ones, zeros], -1),
         np.stack([-sa, zeros, ca], -1)],
        -2,
    )
    jr = np.arange(-TM_NOISE_RANGE, TM_NOISE_RANGE + 1, dtype=np.float32) * np.float32(TM_VOXEL_SIZE)
    jx, jy = np.meshgrid(jr, jr, indexing="ij")
    jitter = np.stack([jx.reshape(-1), jy.reshape(-1), np.zeros(jr.size ** 2, np.float32)], -1)
    return R.astype(np.float32), jitter.astype(np.float32)


_ROT, _JITTER = _host_tables()


class SweepTables(NamedTuple):
    """The sweep's constant tables on one device, made once outside the
    frame step (a copy from host memory inside it is one that a CUDA graph's
    capture refuses)."""

    rot: torch.Tensor     # f32[A, 3, 3] yaw rotations
    jitter: torch.Tensor  # f32[J, 3] translation jitters
    ray_steps: torch.Tensor  # f32[fs_ray_steps] sample distances along a ray


def sweep_tables(g: MatchGridConfig, device) -> SweepTables:
    """The tables of :class:`SweepTables` for grid ``g`` on ``device``."""
    ks = np.arange(g.fs_ray_steps, dtype=np.float32) * np.float32(TM_VOXEL_SIZE)
    return SweepTables(*(torch.from_numpy(a).to(device) for a in (_ROT, _JITTER, ks)))


def take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-d index tensor ``i``, on the device: indexing by a
    0-d tensor reads it to the host (``.item()``)."""
    return t.index_select(0, i.reshape(1))[0]


def _cell_index(g: MatchGridConfig, pts, origin, vs):
    """World point [..., 3] -> (flat cell index, in-bounds); out-of-grid
    points get the drop cell ``num_cells``.  C-trunc division like the
    reference's int casts (pointcloud_tools.h:748-750); clamping to
    [-1, grid_n] first keeps the int conversion defined and decides nothing
    (rel < 0 or idx >= grid_n is out either way)."""
    rel = (pts - origin) / vs
    idx = rel.clamp(-1.0, float(g.grid_n)).to(torch.int32)
    inb = ((rel >= 0) & (idx < g.grid_n)).all(dim=-1)
    flat = (idx[..., 0] * g.grid_n + idx[..., 1]) * g.grid_n + idx[..., 2]
    return torch.where(inb, flat, g.num_cells), inb


def _rotate(R, pts):
    """``pts @ R.T`` row by row for a stack of rotations: R [A, 3, 3],
    pts [P, 3] -> [A, P, 3]."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return torch.stack(
        [R[:, i, 0, None] * x + R[:, i, 1, None] * y + R[:, i, 2, None] * z for i in range(3)], -1
    )


def _sq_norm(v):
    """|v|^2 over the last axis as (x*x + y*y) + z*z."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


class _Source(NamedTuple):
    """What the sweep needs of one source cloud (shared by every template)."""

    closest: torch.Tensor   # f32[3] the source point closest to the camera
    push: torch.Tensor      # f32[3]
    origin: torch.Tensor    # f32[3] grid anchor
    occ: torch.Tensor       # bool[C] occupied cells
    free: torch.Tensor      # bool[C] observed-free cells (FS variant)
    occupied_count: torch.Tensor  # i64


def _prepare_source(g: MatchGridConfig, use_freespace: bool, src, src_valid, cam_pos, vs,
                    ks) -> _Source:
    dev = src.device
    C = g.num_cells
    big = constant(_BIG, torch.float32, dev)

    bb_min = torch.where(src_valid[:, None], src, big).amin(dim=0)
    d2 = torch.where(src_valid, _sq_norm(src - cam_pos), big)
    closest = take(src, torch.argmin(d2))

    expand = TM_EXPAND if use_freespace else 0
    origin = bb_min - constant(expand * TM_VOXEL_SIZE, torch.float32, dev)

    cell, _ = _cell_index(g, src, origin, vs)
    cell = torch.where(src_valid, cell, C)
    occ = torch.zeros(C + 1, dtype=torch.bool, device=dev)
    occ.index_fill_(0, cell.long(), True)
    occ = occ[:C]
    occupied_count = occ.sum()

    if use_freespace:
        # Rays camera -> each source point, marking free cells until the ray
        # meets an occupied cell; samples at k * step, k = 0..S-1
        # (pointcloud_tools.h:957-983).
        ray = src - cam_pos
        ray_len = torch.sqrt(_sq_norm(ray))[:, None]
        ray_dir = ray / torch.clamp(ray_len, min=1e-6)
        samples = cam_pos + ray_dir[:, None, :] * ks[None, :, None]   # [N, S, 3]
        scell, sinb = _cell_index(g, samples, origin, vs)
        live = src_valid[:, None] & (ks[None, :] < ray_len) & (ray_len > 1e-6)
        hit_occ = occ[torch.clamp(scell, max=C - 1).long()] & sinb
        # Inclusive: the occupied cell itself breaks before being marked.
        blocked = torch.cumsum(hit_occ.to(torch.int32), dim=1) > 0
        mark = live & sinb & ~blocked
        scell = torch.where(mark, scell, C)
        free = torch.zeros(C + 1, dtype=torch.bool, device=dev)
        free.index_fill_(0, scell.reshape(-1).long(), True)
        free = free[:C] & ~occ
    else:
        free = occ  # unused

    # Push vector: closest point direction, 10 m (pointcloud_tools.h:735-738).
    to_closest = closest - cam_pos
    norm = torch.sqrt(_sq_norm(to_closest))
    push_distance = constant(TM_PUSH_DISTANCE, torch.float32, dev)
    push = to_closest / torch.clamp(norm, min=1e-6) * push_distance
    return _Source(closest, push, origin, occ, free, occupied_count)


def _sweep_one(g: MatchGridConfig, use_freespace: bool, s: _Source, tpl, tpl_valid, vs,
               tables: SweepTables):
    """All A*J hypotheses of one template -> (score f32, tmatrix f32[4, 4],
    aligned f32[P, 3])."""
    dev = tpl.device
    C = g.num_cells
    R, jitter = tables.rot, tables.jitter
    A, J, P = R.shape[0], jitter.shape[0], tpl.shape[0]

    # Rotate, then move by the push (transform order, pointcloud_tools.h:778-781).
    rot = _rotate(R, tpl) + s.push                                     # [A, P, 3]
    td2 = torch.where(tpl_valid, _sq_norm(rot), constant(_BIG, torch.float32, dev))
    tpl_closest = rot[torch.arange(A, device=dev), torch.argmin(td2, dim=1)]
    correct = s.closest - tpl_closest                                  # [A, 3]

    pts = rot[:, None] + (correct[:, None, :] + jitter[None])[:, :, None, :]  # [A, J, P, 3]
    ccell, _ = _cell_index(g, pts, s.origin, vs)
    ccell = torch.where(tpl_valid, ccell, C).reshape(A * J, P).long()
    # Unique-voxel dedup per hypothesis: scatter-OR into [A*J, C + 1].
    rows = torch.arange(A * J, device=dev)[:, None] * (C + 1)
    hit = torch.zeros(A * J * (C + 1), dtype=torch.bool, device=dev)
    hit.index_fill_(0, (rows + ccell).reshape(-1), True)
    hit = hit.view(A * J, C + 1)[:, :C]
    inter = (hit & s.occ).sum(dim=1)
    if use_freespace:
        inter = inter - (hit & s.free).sum(dim=1)
    del hit

    best = torch.argmax(inter)  # first max wins == reference's strict '>'
    best_a, best_j = best // J, best % J
    move = s.push + take(correct, best_a) + take(jitter, best_j)
    Rb = take(R, best_a)
    T = torch.eye(4, dtype=torch.float32, device=dev)
    T[:3, :3] = Rb
    T[:3, 3] = move
    aligned = _rotate(Rb[None], tpl)[0] + move
    score = take(inter, best).to(torch.float32) / torch.clamp(s.occupied_count, min=1).to(torch.float32)
    return score, T, aligned


def template_match(
    g: MatchGridConfig,
    use_freespace: bool,
    src: torch.Tensor,        # f32[N, 3] source cloud (world frame)
    src_valid: torch.Tensor,  # bool[N]
    cam_pos: torch.Tensor,    # f32[3]
    tpl: torch.Tensor,        # f32[P, 3] centered template
    tpl_valid: torch.Tensor,  # bool[P]
    tables: Optional[SweepTables] = None,
) -> MatchResult:
    """findBestTemplateTransformationPHD[FSConsidered]
    (pointcloud_tools.h:686-865 / 874-1097); no host sync.  ``tables``:
    :func:`sweep_tables` on the source's device (made here when None)."""
    tables = tables or sweep_tables(g, src.device)
    vs = constant(TM_VOXEL_SIZE, torch.float32, src.device)
    s = _prepare_source(g, use_freespace, src, src_valid, cam_pos, vs, tables.ray_steps)
    score, T, aligned = _sweep_one(g, use_freespace, s, tpl, tpl_valid, vs, tables)
    return MatchResult(score=score, tmatrix=T, aligned=aligned)


def template_match_bank(
    g: MatchGridConfig,
    use_freespace: bool,
    src: torch.Tensor,         # f32[N, 3]
    src_valid: torch.Tensor,   # bool[N]
    cam_pos: torch.Tensor,     # f32[3]
    tpls: torch.Tensor,        # f32[T, P, 3] centered templates
    tvalids: torch.Tensor,     # bool[T, P]
    tables: Optional[SweepTables] = None,
):
    """alignTemplatesToPointCloud (pointcloud_tools.h:333-360): sweep every
    template of the bank (one batched sweep each, the source prepared once)
    and argmax the score on the device; ties keep the lowest template index.
    ``tables`` as for :func:`template_match`.

    Returns (best_idx i64, best_score f32, aligned f32[P, 3])."""
    tables = tables or sweep_tables(g, src.device)
    vs = constant(TM_VOXEL_SIZE, torch.float32, src.device)
    s = _prepare_source(g, use_freespace, src, src_valid, cam_pos, vs, tables.ray_steps)
    outs = [_sweep_one(g, use_freespace, s, tpls[t], tvalids[t], vs, tables)
            for t in range(tpls.shape[0])]
    scores = torch.stack([o[0] for o in outs])
    aligned = torch.stack([o[2] for o in outs])
    best = torch.argmax(scores)
    return best, take(scores, best), take(aligned, best)


# ---------------------------------------------------------------------------
# Host-side helpers (numpy; clouds are tiny)
# ---------------------------------------------------------------------------


def compute_mhd(source: np.ndarray, target: np.ndarray) -> float:
    """computeMHD (pointcloud_tools.h:488-501): mean over source points of the
    nearest-neighbor distance to target."""
    if source.shape[0] == 0 or target.shape[0] == 0:
        return float("inf")
    d2 = ((source[:, None, :] - target[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.min(axis=1)).mean())


def remove_outliers(
    cloud: np.ndarray,
    leaf: float = 0.1,
    cluster_tol: float = 0.2,
    min_cluster: int = 100,
    max_cluster: int = 20000,
) -> np.ndarray:
    """removeOutliers (pointcloud_tools.h:425-469): voxel-grid downsample then
    keep the largest Euclidean cluster.  Clustering over the downsampled cells
    uses 26-neighbor connectivity at the cluster tolerance (equivalent to
    PCL's euclidean clustering at tol >= 2*leaf on gridded points)."""
    if cloud.shape[0] == 0:
        return cloud
    # Voxel downsample: centroid per leaf cell.
    cell = np.floor(cloud / leaf).astype(np.int64)
    key = (cell[:, 0] << 42) + (cell[:, 1] << 21) + cell[:, 2]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, start = np.unique(key_s, return_index=True)
    sums = np.add.reduceat(cloud[order], start, axis=0)
    counts = np.diff(np.append(start, key_s.size))
    down = (sums / counts[:, None]).astype(np.float32)

    # Union-find over cells within cluster_tol.
    r = int(np.ceil(cluster_tol / leaf))
    cells = np.floor(down / leaf).astype(np.int64)
    index = {tuple(c): i for i, c in enumerate(cells)}
    parent = np.arange(down.shape[0])

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    tol2 = cluster_tol * cluster_tol
    for i, c in enumerate(cells):
        for dx in range(-r, r + 1):
            for dy in range(-r, r + 1):
                for dz in range(-r, r + 1):
                    j = index.get((c[0] + dx, c[1] + dy, c[2] + dz))
                    if j is not None and j != i:
                        if ((down[i] - down[j]) ** 2).sum() <= tol2:
                            parent[find(i)] = find(j)

    roots = np.array([find(i) for i in range(down.shape[0])])
    labels, counts = np.unique(roots, return_counts=True)
    counts = np.where(counts > max_cluster, 0, counts)
    if counts.max(initial=0) < min_cluster:
        return np.zeros((0, 3), np.float32)
    best = labels[np.argmax(counts)]
    return down[roots == best]
