"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: state conversion through numpy, and the tiny dynamic scenes of
tests/test_full_frame_oracle.py (superpoint and ZED2 mode)."""

import dataclasses

import numpy as np

# The bench scenes are empty at ``tiny_test_config()`` (depths of 3.5-28 m
# against a 4 x 2 x 4 m grid): their tests run at these reduced presets.
from semantic_dsp_map_tpu_torch.benchmarks.scenes import REDUCED_VKITTI2, REDUCED_ZED2  # noqa: F401


#: Object-layer floats come out of a 3x3 f32 SVD (Kabsch refit), whose
#: LAPACK routines differ between the two frameworks by a few ulp of the
#: largest entry; a velocity that is ~0 in one can be ~1e-6 in the other.
OBJECT_ATOL = 1e-5


#: The same for scenes whose objects stand 8-28 m from the origin (the bench
#: scenes): an ulp there is 1e-6 to 2e-6, and a velocity is a fitted
#: translation over a 0.1 s frame, ten times the translation's error.
OBJECT_ATOL_FAR = 2e-4


def assert_states_match(js: dict, ts: dict, msg: str, object_atol: float = OBJECT_ATOL):
    """All integer leaves equal; float leaves at rtol 2e-4 with atol 1e-6,
    object floats at atol ``object_atol``."""
    for key, a in js.items():
        b = ts[key]
        if a.dtype.kind == "f":
            atol = object_atol if key.startswith("objects.") else 1e-6
            np.testing.assert_allclose(b, a, rtol=2e-4, atol=atol, err_msg=f"{key} {msg}")
        else:
            np.testing.assert_array_equal(
                b.astype(np.int64), a.astype(np.int64), err_msg=f"{key} {msg}"
            )


def jax_state_to_numpy(state) -> dict:
    """JAX MapState -> {leaf name: numpy array} in the naming of
    ``semantic_dsp_map_tpu_torch.state.map_state_to_numpy`` (no RNG)."""
    out = {}
    for group in ("particles", "scroll", "objects"):
        obj = getattr(state, group)
        for f in dataclasses.fields(obj):
            out[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    for name in ("voxel_stamp", "global_time", "prev_frame_time"):
        out[name] = np.asarray(getattr(state, name))
    return out


def dynamic_scene(cfg, t, masks_cls):
    """Frame t of the 10-frame dynamic scene of test_full_frame_oracle.py:
    static wall, far free-space band, a tracked car moving right, ego
    motion; irrational-ish constants keep moved particles off pixel and
    voxel boundaries.  Returns (depth, masks, cam_pos, cam_quat, time)."""
    H, W = cfg.height, cfg.width
    depth = np.full((H, W), 1.5873, np.float32)
    depth[:4, :] = 9.5111
    static = np.full((H, W), 6, np.uint8)
    car = np.zeros((H, W), np.uint8)
    car[8:16, 4 + t : 12 + t] = 1
    depth[car > 0] = 1.2157
    dx, dy = 0.15131, 0.02071
    kpts = np.array(
        [
            [0.2071 + dx * t, dy * t, 1.2157],
            [0.6113 + dx * t, dy * t, 1.2157],
            [0.2071 + dx * t, -0.3041 + dy * t, 1.2157],
            [0.6113 + dx * t, -0.3041 + dy * t, 1.2157],
            [0.2071 + dx * t, dy * t, 1.5119],
        ],
        np.float32,
    )
    masks = [
        masks_cls(track_id=65535, label="static", mask=static),
        masks_cls(
            track_id=3, label="Car", mask=car, kpts_current=kpts,
            kpts_previous=kpts - np.array([dx, dy, 0], np.float32),
        ),
    ]
    cam_pos = np.array([0.02133 * t, 0, 0.26177 * t], np.float32)
    cam_quat = np.array([1, 0, 0, 0], np.float32)
    return depth, masks, cam_pos, cam_quat, 0.15 * t


def zed2_scene(cfg, t, masks_cls):
    """Frame t of the 10-frame ZED2 (bbox3d) scene of
    test_full_frame_oracle.py: a sky band (culled), mask bleed onto a far
    wall (bbox-gated to Background), a moving 4-corner-bbox car, 0.35 s
    frames so the 2 s key-corner refresh fires mid-sequence.  Returns
    (depth, masks, cam_pos, cam_quat, time)."""
    H, W = cfg.height, cfg.width
    depth = np.full((H, W), 1.5873, np.float32)
    depth[:3, :] = 9.5111
    depth[:, 26:] = 3.0873
    static = np.full((H, W), 6, np.uint8)
    static[3:7, :] = 2
    car = np.zeros((H, W), np.uint8)
    car[9:16, 6 + t : 13 + t] = 1
    car[9:16, 26:29] = 1
    depth[9:16, 6 + t : 13 + t] = 1.2157
    dx, dy = 0.05131, 0.01071
    kpts = np.array(
        [
            [0.0071 + dx * t, dy * t, 1.2157],
            [0.2184 + dx * t, dy * t, 1.2157],
            [0.0071 + dx * t, -0.2041 + dy * t, 1.2157],
            [0.2184 + dx * t, -0.2041 + dy * t, 1.2157],
        ],
        np.float32,
    )
    masks = [
        masks_cls(track_id=65535, label="static", mask=static),
        masks_cls(
            track_id=4, label="Car", mask=car, kpts_current=kpts,
            kpts_previous=kpts - np.array([dx, dy, 0], np.float32),
        ),
    ]
    cam_pos = np.array([0.01133 * t, 0, 0.03177 * t], np.float32)
    cam_quat = np.array([1, 0, 0, 0], np.float32)
    return depth, masks, cam_pos, cam_quat, 0.35 * t


def static_camera(scene):
    """``scene`` with the camera held at the origin: cloud-born particles
    then reproject onto integer pixel coordinates, where one ulp of the
    back-projection decides the pixel."""

    def frame(cfg, t, masks_cls):
        depth, masks, _, cam_quat, time = scene(cfg, t, masks_cls)
        return depth, masks, np.zeros(3, np.float32), cam_quat, time

    return frame


#: The small template scene: a 96 x 72 camera over a 16 x 8 x 32 grid, a
#: wall and a Car large enough for template birth (2,940 mask pixels, a
#: 3.5 x 2.1 m box).  Depths are off the 0.25 m voxel boundaries.
TEMPLATE_SCENE_CFG = dict(image_width=96, image_height=72, camera_fx=60, camera_fy=60,
                          camera_cx=48, camera_cy=36, voxel_num_axis_z_n=5)
TEMPLATE_SCENE_GRID = dict(grid_n=32, max_source_points=4096, max_template_points=2048,
                           fs_ray_steps=96)


def template_scene(cfg, t, masks_cls):
    """Frame t of the small template scene: a static car; the camera drifts
    a quarter pixel per frame (``static_camera`` holds it still: the two
    packages' clouds agree bit for bit, so both variants are tested).
    Returns (depth, masks, cam_pos, cam_quat, time)."""
    H, W = cfg.height, cfg.width
    depth = np.full((H, W), 3.5117, np.float32)
    car = np.zeros((H, W), np.uint8)
    car[20:62, 10:80] = 1
    depth[car > 0] = 3.0123
    kpts = np.array([[-1.2, 0, 3], [1.0, 0, 3], [-1.2, -0.6, 3], [1.0, -0.6, 3],
                     [-1.2, 0, 3.4]], np.float32)
    masks = [
        masks_cls(track_id=65535, label="static", mask=np.full((H, W), 6, np.uint8)),
        masks_cls(track_id=3, label="Car", mask=car, kpts_current=kpts, kpts_previous=kpts),
    ]
    cam_pos = np.array([0.01313 * t, 0.00517 * t, 0.0], np.float32)
    return depth, masks, cam_pos, np.array([1, 0, 0, 0], np.float32), 0.1 * t


def hold_scene_against_jax(jcfg, tcfg, params: dict, scene, frames, on_frame=None,
                           object_atol: float = OBJECT_ATOL):
    """Step ``scene(cfg, t, mask_cls) -> (depth, masks, pos, quat[, time])``
    through the JAX map and the port's map on the CPU: every counter, ``occ``,
    ``label`` and ``track`` equal on every frame, ``weight_sum`` and the state
    within ``assert_states_match``'s tolerances (object floats at
    ``object_atol``).  ``on_frame(t, jm, tm)`` runs
    after each frame.  Returns the per-frame counters and the two maps."""
    import semantic_dsp_map_tpu as J
    import semantic_dsp_map_tpu_torch as T
    from semantic_dsp_map_tpu_torch.state import map_state_to_numpy

    jm = J.SemanticDSPMap(jcfg, J.FilterParams(**params))
    tm = T.SemanticDSPMap(tcfg, T.FilterParams(**params), device="cpu")
    diags = []
    for t in range(frames):
        out = []
        for m, cls in ((jm, J.MaskKpts), (tm, T.MaskKpts)):
            fr = scene(m.cfg, t, cls)
            time = fr[4] if len(fr) > 4 else 0.1 * t
            out.append(m.update(fr[0], fr[1], fr[2], fr[3], time))
        (jr, jd), (tr, td) = out
        msg = f"frame {t}"
        jdd = {k: int(v) for k, v in jd._asdict().items()}
        tdd = {k: int(v) for k, v in td._asdict().items()}
        assert tdd == jdd, msg
        for name in ("occ", "label", "track"):
            np.testing.assert_array_equal(
                getattr(tr, name).numpy(), np.asarray(getattr(jr, name)), err_msg=f"{name} {msg}")
        np.testing.assert_allclose(tr.weight_sum.numpy(), np.asarray(jr.weight_sum), rtol=2e-4,
                                   atol=1e-6, err_msg=f"weight_sum {msg}")
        assert_states_match(jax_state_to_numpy(jm.state), map_state_to_numpy(tm.state), msg,
                            object_atol)
        diags.append(tdd)
        if on_frame is not None:
            on_frame(t, jm, tm)
    return diags, jm, tm


def occ_counts(occ) -> dict:
    """Counts of occupied (1), free (0) and unknown (-1) voxels."""
    occ = np.asarray(occ)
    return {"occupied": int((occ == 1).sum()), "free": int((occ == 0).sum()),
            "unknown": int((occ == -1).sum())}


def without_keypoints(scene, lost):
    """``scene`` with the tracked car's keypoints withheld on the frames in
    ``lost`` (the tracker lost them; the mask stays).  The keypoint fit cannot
    run on such a frame.  If the object is moving by then, the object layer
    coasts on the object's velocity where its transform window holds two
    moves, and flags the object for cloud rematching where it does not.  In
    ``dynamic_scene`` with the default Bayesian parameters the car counts as
    moving from frame 2 and has a velocity from frame 3: frame 3 without
    keypoints takes the rematch branch, a later one the coast branch."""

    def frame(cfg, t, masks_cls):
        depth, masks, pos, quat, time = scene(cfg, t, masks_cls)
        if t in lost:
            masks[1].kpts_current = None
            masks[1].kpts_previous = None
        return depth, masks, pos, quat, time

    return frame


# ---------------------------------------------------------------------------
# Seeded inputs of the PHD passes and the observe scans, as numpy, for the
# CPU tests (port's plain versions against the JAX package) and the GPU tests
# (CUDA kernels against the plain versions): both see the same edge cases.
# ---------------------------------------------------------------------------

#: Occupancy patterns of the pixel table beside the random ones: every slot
#: of every pixel, none, one rectangular patch, and a random table with one
#: planted entry whose forgetting factor is 0 (see phd_table_cloud).
PHD_EDGE_TABLES = ("full", "empty", "patch", "zero_ff")

#: The planted entry of the "zero_ff" table: slot, row, column.
ZERO_FF_ENTRY = (0, 7, 9)


def phd_table_cloud(S, H, W, seed=0, fill=0.4, front_fill=False, kind=None):
    """Pixel table and observation cloud as dicts of numpy arrays (the
    generator of tests/test_phd_pallas.py).  ``kind`` picks an occupancy of
    PHD_EDGE_TABLES instead of the random one.  "zero_ff" plants at
    ZERO_FF_ENTRY an occupied entry with forget count 5 (forgetting factor 0
    at the default max_forget_count) that sits exactly on its own pixel's
    valid same-track observation: its weight sum is 0 and its "rightly
    updated" flag must still be set."""
    rng = np.random.RandomState(seed)
    if kind == "full":
        occ = np.ones((S, H, W), bool)
    elif kind == "empty":
        occ = np.zeros((S, H, W), bool)
    elif kind == "patch":
        occ = np.zeros((S, H, W), bool)
        ys, xs = slice(H // 4, H // 4 + H // 3), slice(W // 2, W // 2 + W // 3)
        occ[:, ys, xs] = (np.arange(S)[:, None, None] < rng.poisson(0.5 * S, (1, H, W)))[:, ys, xs]
    elif front_fill or kind == "zero_ff":
        occ = np.arange(S)[:, None, None] < rng.poisson(fill * S, (1, H, W))
    else:
        occ = rng.rand(S, H, W) < fill
    track = rng.randint(0, 5, (S, H, W)).astype(np.int32)
    forget = rng.randint(0, 6, (S, H, W)).astype(np.int32)
    table = dict(
        px=np.where(occ, rng.randn(S, H, W), 0).astype(np.float32),
        py=np.where(occ, rng.randn(S, H, W), 0).astype(np.float32),
        pz=np.where(occ, rng.rand(S, H, W) * 4 + 1, 0).astype(np.float32),
        weight=np.where(occ, rng.rand(S, H, W), 0).astype(np.float32),
        meta=np.where(occ, (track << 8) | forget, -1).astype(np.int32),
    )
    cloud = dict(
        pos=(rng.randn(H, W, 3) + np.array([0, 0, 2.5])).astype(np.float32),
        sigma=(0.2 + rng.rand(H, W) * 0.2).astype(np.float32),
        label=rng.randint(0, 10, (H, W)).astype(np.int32),
        track=rng.randint(0, 5, (H, W)).astype(np.int32),
        valid=rng.rand(H, W) < 0.85,
    )
    if kind == "zero_ff":
        s, y, x = ZERO_FF_ENTRY
        cloud["valid"][y, x] = True
        table["px"][s, y, x], table["py"][s, y, x], table["pz"][s, y, x] = cloud["pos"][y, x]
        table["weight"][s, y, x] = 0.5
        table["meta"][s, y, x] = (int(cloud["track"][y, x]) << 8) | 5
    return table, cloud


#: Particle stores beside the mixed one: every slot dead (status INVALID),
#: every slot alive (a status set and a stamp no older than any scroll
#: stamp), and a map that is empty but for one stretch of slots.
STORE_EDGES = ("mixed", "all_dead", "all_alive", "sparse")


def particle_store(n_slots, axis_sizes, seed, max_movable, kind="mixed"):
    """Flat particle fields and per-axis scroll stamps as numpy: positions
    spread over and around the frustum, status 0-3, stamps 0-3 against
    scroll stamps 0-2, tracks on both sides of ``max_movable``."""
    rng = np.random.RandomState(seed)
    n = n_slots
    track = rng.randint(0, 12, n)
    track = np.where(rng.rand(n) < 0.3, max_movable + rng.randint(-2, 12, n), track)
    d = dict(
        px=(rng.randn(n) * 2).astype(np.float32),
        py=(rng.randn(n) * 2).astype(np.float32),
        pz=(rng.rand(n) * 10 - 1).astype(np.float32),
        status=rng.randint(0, 4, n).astype(np.uint8),
        stamp=rng.randint(0, 4, n).astype(np.int32),
        track=track.astype(np.int32),
        axis=[rng.randint(0, 3, k).astype(np.int32) for k in axis_sizes],
    )
    if kind == "all_dead":
        d["status"][:] = 0
    elif kind == "all_alive":
        d["status"] = rng.randint(1, 4, n).astype(np.uint8)
        d["stamp"][:] = 2
    elif kind == "sparse":
        d["status"][: n // 3] = 0
        d["status"][n // 3 + max(1, n // 50) :] = 0
    return d


def render_store(V, K, seed, kind="mixed"):
    """The render's inputs as numpy: ``particle_store`` of ``kind`` (status,
    stamp, per-voxel scroll stamps 0-2) with weights on both sides of the
    clamp at 1 and of the newborn weight (an eighth of them feeble, for the
    collection), labels 0-7, tracks 0-3 (ties in the per-track sums), and
    voxel stamps 0-3, a share of them stale (0, or older than the scroll
    stamp)."""
    d = particle_store(V * K, (V, 1, 1), seed, max_movable=2, kind=kind)
    rng = np.random.RandomState(seed + 1000)
    n = V * K
    weight = (rng.rand(n) * 1.4).astype(np.float32)
    weight[rng.rand(n) < 0.125] *= 0.05
    return dict(
        weight=weight, stamp=d["stamp"], status=d["status"],
        track=(d["track"] % 4).astype(np.int32), label=rng.randint(0, 8, n).astype(np.uint8),
        vax=d["axis"][0], voxel_stamp=rng.randint(0, 4, V).astype(np.int32),
    )


#: The render's stores for its generic instance (K past 31: a block of 256
#: threads streams a span of 256 voxels, the warps share the voxels with a
#: status): one voxel with a status per span, at its first and at its last
#: voxel; every voxel of every span valid and every slot alive; alive slots
#: of weight -0.0, +0.0 and NaN; two tracks whose same-track sums tie.
RENDER_GENERIC_EDGES = ("first_of_span", "last_of_span", "span_all_live", "signed_zeros_nan",
                        "track_ties")


def render_generic_store(V, K, seed, kind):
    """The render's inputs as numpy (``render_store``'s fields) for a kind
    of ``RENDER_GENERIC_EDGES``."""
    d = render_store(V, K, seed, "mixed")
    rng = np.random.RandomState(seed + 2000)
    n = V * K
    status, stamp, weight = d["status"], d["stamp"], d["weight"]
    slots = status.reshape(V, K)
    if kind in ("first_of_span", "last_of_span"):
        keep = np.zeros(V, bool)
        keep[0 if kind == "first_of_span" else 255::256] = True
        if kind == "last_of_span":
            keep[V - 1] = True  # the last voxel of a ragged last span
        slots[~keep] = 0
        d["voxel_stamp"][keep] = 3  # valid: the scroll stamps are 0-2
        stamp.reshape(V, K)[keep] = np.where(rng.rand(int(keep.sum()), K) < 0.8, 3, 0)
    elif kind == "span_all_live":
        status[:] = rng.randint(1, 4, n)
        stamp[:] = 2
        d["voxel_stamp"][:] = 3
    elif kind == "signed_zeros_nan":
        d["voxel_stamp"][:] = 3
        stamp[:] = np.where(rng.rand(n) < 0.9, 3, 0)
        u = rng.rand(n)
        weight[u < 0.1] = -0.0
        weight[(u >= 0.1) & (u < 0.2)] = 0.0
        # every voxel's first slot contributes with a weight of -0.0: its
        # same-track sum starts at -0.0; one slot of every third voxel NaN
        slots[:, 0] = 2
        w = weight.reshape(V, K)
        w[:, 0] = -0.0
        w[::3, 1 + rng.randint(0, K - 1)] = np.nan
    elif kind == "track_ties":
        # each voxel: m alive slots, half of track a and half of track b, and
        # one slot of a third track with less weight.  A third of the voxels:
        # the same dyadic weights in another order, an exact tie; a third:
        # b's largest weight raised by 1/16 and its smallest lowered by
        # 1/16 + 1/1024, so a wins by 1/1024 while b holds the heaviest slot
        # (a sum that counted a slot twice would pick b); a third: the same
        # non-dyadic weights in another order, tied or not by the rounding
        # of the sums in their order.
        d["voxel_stamp"][:] = 3
        stamp[:] = 3
        status[:] = 0
        trk = d["track"].reshape(V, K)
        w = weight.reshape(V, K)
        for v in range(V):
            m = min(K - 1, 2 * rng.randint(2, 10))
            pos = rng.choice(K, m + 1, replace=False)
            if v % 3 == 2:
                half = rng.rand(m // 2).astype(np.float32) * 0.9 + 0.05
            else:
                half = rng.choice([0.125, 0.25, 0.375, 0.5, 0.625, 0.75], m // 2).astype(np.float32)
            other = rng.permutation(half)
            if v % 3 == 1:
                other[np.argmax(other)] += 0.0625
                other[np.argmin(other)] -= 0.0625 + 1 / 1024
            a, b = rng.choice(4, 2, replace=False)
            slots[v, pos] = rng.choice([2, 3], m + 1)
            trk[v, pos[: m // 2]], w[v, pos[: m // 2]] = a, half
            trk[v, pos[m // 2: m]], w[v, pos[m // 2: m]] = b, other
            trk[v, pos[m]], w[v, pos[m]] = 6 - a - b if a + b != 3 else 0, 0.0625
    else:
        raise ValueError(kind)
    return d


#: Birth's merge working sets beside the random one: every slot of a real
#: row UPDATED, all but two a voxel alive (so more than the resample
#: trigger), with one heavy slot a voxel whose walk advances its threshold
#: K + 8 times, the bound of the loop; and the same with a weight sum below
#: 0.01 (the wipe).
MERGE_KINDS = ("random", "walk_bound", "wipe")


def merge_working_set(K: int, bv: int, A: int, n_real: int, nb: int, seed: int,
                      kind: str = "random") -> dict:
    """Random inputs of birth's merge stage (``ops.birth.merge_blocks_plain``)
    over a store of ``nb`` blocks of ``bv`` voxels of K slots: the store's
    nine fields, the voxels' scroll stamps (some slots stale), ``A`` target
    rows of which the first ``n_real`` are real (ascending unique block ids,
    then the padding ids nb + row), and the staged candidates [A, bv, K]
    (0 to K a voxel, as a prefix, meta -1 elsewhere).  A tenth of the
    voxels hold weights near 1e-4, whose resample wipes; UPDATED is the
    likeliest status, so most targeted voxels walk.  ``kind``: one of
    ``MERGE_KINDS``.  Returns numpy arrays by name."""
    rng = np.random.RandomState(seed)
    V = nb * bv
    n = V * K
    vox_scale = np.where(rng.rand(V) < 0.1, 1e-4, 0.6).astype(np.float32)
    out = dict(
        px=rng.randn(n).astype(np.float32), py=rng.randn(n).astype(np.float32),
        pz=rng.randn(n).astype(np.float32),
        weight=(rng.rand(n).astype(np.float32) * np.repeat(vox_scale, K)),
        label=rng.randint(0, 256, n).astype(np.uint8),
        track=rng.randint(0, 65536, n).astype(np.int32),
        status=rng.choice([0, 1, 2, 3], n, p=[0.15, 0.7, 0.1, 0.05]).astype(np.uint8),
        forget=rng.randint(0, 8, n).astype(np.uint8),
        stamp=rng.randint(0, 8, n).astype(np.int32),
        vox_axis=rng.choice([0, 1, 2], V, p=[0.8, 0.15, 0.05]).astype(np.int32),
    )
    ids = nb + np.arange(A, dtype=np.int64)
    ids[:n_real] = np.sort(rng.choice(nb, n_real, replace=False))
    out["ids"], out["count"] = ids, np.int64(n_real)
    n_staged = rng.randint(0, K + 1, (A, bv))
    n_staged[n_real:] = 0
    occupied = np.arange(K)[None, None, :] < n_staged[:, :, None]
    meta = ((rng.randint(0, 8, occupied.shape) << 27) | (rng.randint(0, 8, occupied.shape) << 24)
            | (rng.randint(0, 256, occupied.shape) << 16) | rng.randint(0, 65536, occupied.shape))
    out["in_meta"] = np.where(occupied, meta, -1).astype(np.int32)
    for name in ("in_px", "in_py", "in_pz"):
        out[name] = np.where(occupied, rng.randn(*occupied.shape), 0.0).astype(np.float32)
    out["in_w"] = np.where(occupied, rng.rand(*occupied.shape), 0.0).astype(np.float32)
    out["in_stamp"] = np.where(occupied, rng.randint(1, 9, occupied.shape), 0).astype(np.int32)
    if kind != "random":
        if kind not in MERGE_KINDS:
            raise ValueError(kind)
        # the real rows' slots: all UPDATED, two a voxel stale (pruned, so
        # vacant even without the resample), each voxel a candidate
        nv = n_real * bv
        slots = (ids[:n_real, None] * bv * K + np.arange(bv * K)).reshape(-1)
        voxels = (ids[:n_real, None] * bv + np.arange(bv)).reshape(-1)
        order = np.argsort(rng.rand(nv, K), axis=1)
        rows = np.arange(nv)[:, None]
        out["status"][slots] = 1
        out["vox_axis"][voxels] = 1
        stamp = np.full((nv, K), 8, np.int32)
        stamp[rows, order[:, :2]] = 0
        out["stamp"][slots] = stamp.reshape(-1)
        w = np.full((nv, K), 1e-3 if kind == "walk_bound" else 0.004 / K, np.float32)
        if kind == "walk_bound":
            # wpp is 1; the heavy slot's sum passes K + 8 steps of it
            w[rows[:, 0], order[:, 2]] = 4.0 * K
        out["weight"][slots] = w.reshape(-1)
        first = np.zeros_like(occupied)
        first[:n_real, :, 0] = True
        out["in_meta"] = np.where(first & (out["in_meta"] < 0), meta, out["in_meta"]).astype(np.int32)
    return out


#: The template gate's edge cases (``template_gate_case``).
TEMPLATE_GATE_EDGES = ("random", "none", "one", "every", "every_valid", "shared_id", "minus_one",
                       "specials", "past_int32")

#: The Car label of ``template_gate_case``'s rows.
GATE_CAR = 3


def template_gate_case(kind, O, H, W, seed=0):
    """The template gate's inputs as numpy: ({object field: [O]}, {cloud
    field: [H, W] or [H, W, 3]}), the rows' ids distinct unless ``kind``
    says otherwise, flags and labels (``GATE_CAR`` or 6) at random.

    none: no pixel has a row's id; one: one valid pixel has one; every: every
    pixel valid and on row 0's id, its x all -inf (no fill joins the max);
    every_valid: every pixel on row 0's id, a fifth of them invalid;
    shared_id: two valid rows and an invalid one share an id; minus_one:
    half the rows invalid with id -1, one valid row with id -1 and many -1
    pixels; specials: NaN, +-0.0 and +-inf coordinates on valid pixels;
    past_int32: extents whose mm pass the int32 range."""
    rng = np.random.RandomState(seed)
    objects = dict(
        valid=rng.rand(O) < 0.7,
        track_id=np.arange(O, dtype=np.int32),
        label=rng.choice([GATE_CAR, 6], O).astype(np.int32),
        **{f: rng.rand(O) < 0.6 for f in ("to_match_previous", "moving", "has_moved_record",
                                           "to_match_templates")},
    )
    objects["valid"][0] = True
    track = rng.randint(-1, O + 4, (H, W)).astype(np.int32)
    valid = rng.rand(H, W) < 0.8
    pos = (rng.randn(H, W, 3) * 10).astype(np.float32)
    row = min(3, O - 1)
    if kind == "none":
        track[:] = O + 5
    elif kind == "one":
        track[:] = O + 5
        i, j = rng.randint(H), rng.randint(W)
        track[i, j], valid[i, j], objects["valid"][row] = row, True, True
    elif kind in ("every", "every_valid"):
        track[:] = 0
        if kind == "every":
            valid[:] = True
            pos[..., 0] = -np.inf
    elif kind == "shared_id":
        objects["track_id"][:3] = row
        objects["valid"][:3] = (True, True, False)
    elif kind == "minus_one":
        objects["track_id"][O // 2:] = -1
        objects["valid"][O // 2:] = False
        objects["track_id"][1], objects["valid"][1] = -1, True
        track[rng.rand(H, W) < 0.5] = -1
    elif kind in ("specials", "past_int32"):
        objects["valid"][:6] = True
        track = rng.randint(0, 6, (H, W)).astype(np.int32)
        valid[:] = True
        xy = pos.reshape(-1, 3)  # a view: rows are pixels
        at = {r: np.flatnonzero(track.reshape(-1) == r) for r in range(6)}
        half = {r: np.arange(len(at[r])) % 2 == 1 for r in range(6)}
        if kind == "specials":
            xy[at[0][:1], 0] = np.nan                          # row 0: a NaN x
            xy[at[1], 0] = np.where(half[1], 0.0, -0.0)        # row 1: x all +-0.0
            xy[at[2][:1], 0], xy[at[2][1:2], 0] = np.inf, -np.inf  # row 2: both infinities
            xy[at[3], 0] = np.inf                              # row 3: inf - inf
            xy[at[4][:1], 1] = np.nan                          # row 4: a NaN y
            xy[at[5], 1] = np.where(half[5], -np.inf, -0.0)    # row 5: y -inf and -0.0
        else:
            xy[at[0], 0] = np.where(half[0], 2e6, -2e6)        # 4e9 mm
            xy[at[1], 1] = np.where(half[1], 3e38, -3e38)      # an infinite extent
            xy[at[2], 0] = np.where(half[2], 2.2e6, 0.0)       # 2.2e9 mm
            xy[at[3], 1] = np.where(half[3], 2.1e6, 0.0)       # 2.1e9 mm: inside int32
    elif kind != "random":
        raise ValueError(kind)
    cloud = dict(pos=pos, sigma=np.ones((H, W), np.float32), label=np.zeros((H, W), np.int32),
                 track=track, valid=valid)
    return objects, cloud


def template_gate_tensors(kind, O, H, W, device):
    """``template_gate_case`` as the gate takes it, on ``device``: (objects,
    cloud)."""
    import types

    import torch
    from semantic_dsp_map_tpu_torch.ops.projection import LabeledCloud

    objects, cloud = template_gate_case(kind, O, H, W)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (types.SimpleNamespace(**{k: T(v) for k, v in objects.items()}),
            LabeledCloud(**{k: T(v) for k, v in cloud.items()}))


#: Rematch's delete pass's edge cases (``template_delete_case``).
TEMPLATE_DELETE_EDGES = ("none", "one", "both", "same_tid", "absent", "every")


def template_delete_case(kind, n, seed=0):
    """Rematch's delete pass's inputs as numpy: (track i32[n], status u8[n],
    good bool[2], tid i32[2]).  none: neither slot good; one: the first
    (the other's id is in the store too); both; same_tid: both good with one
    id; absent: the good slot's id is in no slot; every: every slot has the
    good slot's id."""
    rng = np.random.RandomState(seed)
    track = rng.randint(-1, 12, n).astype(np.int32)
    status = rng.randint(0, 5, n).astype(np.uint8)
    tid = np.array([3, 5], np.int32)
    good = {"none": (False, False), "one": (True, False), "both": (True, True),
            "same_tid": (True, True), "absent": (True, False), "every": (True, False)}[kind]
    if kind == "same_tid":
        tid[1] = 3
    elif kind == "absent":
        tid[0] = 40
    elif kind == "every":
        track[:] = 3
    return track, status, np.array(good), tid


def deleted_as_expected(track, status, good, tid):
    """What rematch's delete pass leaves of ``status`` (numpy)."""
    out = status.copy()
    out[np.isin(track, tid[good])] = 0
    return out
