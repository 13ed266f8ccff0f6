"""What the ranks of tests/test_torch_shard_step.py run.

This module imports no JAX (nor does anything it imports): the tests' ranks
are spawned processes that import it, which keeps a spawn fast and shows
that the port's sharded step runs without JAX.  Every function a rank runs
takes the rank's device first (``parallel.distributed.spawn_ranks``).
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from semantic_dsp_map_tpu_torch.frontend import FrameInput, build_frame_input, pack_frame
from semantic_dsp_map_tpu_torch.labels import LabelRegistry
from semantic_dsp_map_tpu_torch.parallel import shard_step
from semantic_dsp_map_tpu_torch.parallel.shard_step import build_shard_step, build_shard_step_eager
from semantic_dsp_map_tpu_torch.parallel.sharding import gather_render, shard_state, unshard_state
from semantic_dsp_map_tpu_torch.ops.phd import PixelTable
from semantic_dsp_map_tpu_torch.state import init_map_state, map_state_to_numpy

from host_sync_audit import HostSyncAudit

#: The runtime parameters of tests/test_shard_step.py's exact scenarios:
#: noise paths off, a movement filter that turns the car moving by frame 3.
EXACT_PARAMS = dict(
    detection_probability=0.9, noise_number=0.01, nb_ptc_num_per_point=1,
    prediction_stddev=0.0, occupancy_threshold=0.3, if_consider_depth_noise=False,
    bayesian_movement_increment=0.4, bayesian_movement_decrement=0.05,
    bayesian_movement_probability_threshold=0.3,
)
#: Its noise-birth scenario: three jittered copies per pixel.
NOISE_PARAMS = dict(
    detection_probability=0.9, noise_number=0.01, nb_ptc_num_per_point=3,
    prediction_stddev=0.0, occupancy_threshold=0.3, if_consider_depth_noise=True,
    depth_noise_model_zero_order=0.05, depth_noise_model_first_order=0.01,
)
#: The static path against its oracle with the noise on: depth noise (the
#: birth's draws) and the rigid move's jitter, both from the rank's
#: generator, RANSAC triples from the state's.
STATIC_NOISE_PARAMS = dict(EXACT_PARAMS, if_consider_depth_noise=True,
                           depth_noise_model_zero_order=0.05, prediction_stddev=0.01)
#: Its overflow scenario.
OVERFLOW_PARAMS = dict(
    detection_probability=0.9, noise_number=0.01, nb_ptc_num_per_point=1,
    prediction_stddev=0.0, occupancy_threshold=0.3, if_consider_depth_noise=False,
)


def raw_frames(cfg, n, mask_cls, bbox3d=False, sky_rows=0):
    """tests/test_shard_step.py's raw (depth, masks, pos, quat, t) frames: a
    static wall and a tracked car whose keypoints are superpoint-style
    features or the 4 corners of a 3D box (ZED2 mode); ``mask_cls`` is
    either package's MaskKpts."""
    H, W = cfg.height, cfg.width
    out = []
    for t in range(n):
        depth = np.full((H, W), 1.6, np.float32)
        static = np.full((H, W), 6, np.uint8)
        if sky_rows:
            # label 2 = "Sky" in the default registry (value+1 convention)
            static[:sky_rows] = 1
            depth[:sky_rows] = 7.5
        car = np.zeros((H, W), np.uint8)
        car[8:16, 4 + t : 12 + t] = 1
        depth[car > 0] = 1.2
        if bbox3d:
            x0 = 0.2 + 0.05 * t
            kpts = np.array([[x0, -0.3, 1.1], [x0 + 0.5, -0.3, 1.1],
                             [x0, 0.2, 1.4], [x0 + 0.5, 0.2, 1.4]], np.float32)
        else:
            kpts = np.array([[0.2 + 0.05 * t, 0, 1.2], [0.6 + 0.05 * t, 0, 1.2],
                             [0.2 + 0.05 * t, -0.3, 1.2], [0.6 + 0.05 * t, -0.3, 1.2],
                             [0.2 + 0.05 * t, 0, 1.5]], np.float32)
        masks = [
            mask_cls(track_id=65535, label="static", mask=static),
            mask_cls(track_id=3, label="Car", mask=car, kpts_current=kpts,
                     kpts_previous=kpts - np.array([0.05, 0, 0], np.float32)),
        ]
        out.append((depth, masks, np.array([0, 0, 0.05 * t], np.float32),
                    np.array([1, 0, 0, 0], np.float32), 0.15 * t))
    return out


def frame_tensors(cfg, registry, raw, device):
    """A raw frame as the step's FrameInput of tensors on ``device``."""
    f = build_frame_input(cfg, registry, *raw)
    return FrameInput(*(torch.as_tensor(np.asarray(a)).to(device) for a in f))


def run_map(device, cfg, params, frames, packed, seed, group):
    """The sharded step over ``frames`` on this rank of ``group``.  Every
    rank returns its counters and object table; the first rank also the
    whole-grid state and render."""
    registry = LabelRegistry.default()
    D, rank = dist.get_world_size(group), dist.get_rank(group)
    state = shard_state(cfg, init_map_state(cfg, seed, device), rank, D)
    step = build_shard_step(cfg, params, registry, group=group, packed=packed)
    diags = []
    for raw in frames:
        if packed:
            f = torch.from_numpy(pack_frame(cfg, registry, *raw)).to(device)
        else:
            f = frame_tensors(cfg, registry, raw, device)
        state, result, diag = step(state, f)
        diags.append({k: int(v) for k, v in diag._asdict().items()})
    whole = map_state_to_numpy(unshard_state(state, group))
    render = {k: v.cpu().numpy() for k, v in gather_render(result, group)._asdict().items()}
    out = {"diags": diags, "objects": {k: v for k, v in whole.items() if k.startswith("objects.")}}
    if rank == 0:
        out.update(state=whole, render=render)
    return out


def step_input(cfg, registry, raw, packed, device):
    """A raw frame as the sharded step's input on ``device``: the packed
    buffer, or the FrameInput of tensors."""
    if packed:
        return torch.from_numpy(pack_frame(cfg, registry, *raw)).to(device)
    return frame_tensors(cfg, registry, raw, device)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _leaves(state):
    """(name, tensor) of every tensor of a map state."""
    out = []
    for field in dataclasses.fields(state):
        v = getattr(state, field.name)
        if isinstance(v, torch.Tensor):
            out.append((field.name, v))
        elif dataclasses.is_dataclass(v):
            out += [(f"{field.name}.{k}", t) for k, t in _leaves(v)]
    return out


def restored_copy(state):
    """A state from outside with ``state``'s values: every tensor cloned, a
    generator of its own in the same state (as a restored checkpoint)."""
    rng = torch.Generator(device=state.rng.device)
    rng.set_state(state.rng.get_state())
    clone = lambda obj: dataclasses.replace(obj, **{
        f.name: (getattr(obj, f.name).clone() if isinstance(getattr(obj, f.name), torch.Tensor)
                 else clone(getattr(obj, f.name)))
        for f in dataclasses.fields(obj) if f.name != "rng"})
    return dataclasses.replace(clone(state), rng=rng)


def parted_names(a, b):
    """Names of what two sharded steps' outputs do not hold bit for bit:
    (state, render, counters, the state's generator, the rank generator)."""
    (sa, ra, da, ga), (sb, rb, db, gb) = a, b
    out = [n for (n, x), (_, y) in zip(_leaves(sa), _leaves(sb)) if not torch.equal(_bits(x), _bits(y))]
    out += [f"render.{n}" for n in ra._fields
            if not torch.equal(_bits(getattr(ra, n)), _bits(getattr(rb, n)))]
    if {k: int(v) for k, v in da._asdict().items()} != {k: int(v) for k, v in db._asdict().items()}:
        out.append("diagnostics")
    if not torch.equal(sa.rng.get_state(), sb.rng.get_state()):
        out.append("rng")
    if not torch.equal(ga.get_state(), gb.get_state()):
        out.append("rank_rng")
    return out


def static_case(device, cfg, params, frames, packed, seed, restore_at, group):
    """``build_shard_step`` (the static path) against ``build_shard_step_eager``
    (its oracle) on the same frames, each on a state of its own: after every
    frame the states (every tensor by its bits), both generators, the renders
    and the nine counters must be equal.  At frame ``restore_at`` each is
    handed a state from outside: a copy of the oracle's state of two frames
    before, with a generator of its own (a restored checkpoint).  Returns
    what parted on each frame, the counters, whether the static state's
    tensors kept their addresses (and the returned state is the static one),
    and whether the step was split at the refit."""
    registry = LabelRegistry.default()
    D, rank = dist.get_world_size(group), dist.get_rank(group)
    static = build_shard_step(cfg, params, registry, group=group, packed=packed)
    eager = build_shard_step_eager(cfg, params, registry, group=group, packed=packed)
    s_static = shard_state(cfg, init_map_state(cfg, seed, device), rank, D)
    s_eager = shard_state(cfg, init_map_state(cfg, seed, device), rank, D)
    first, kept, saved = s_static, True, {}
    ptrs = {n: t.data_ptr() for n, t in _leaves(s_static)}
    parted, diags = [], []
    for t, raw in enumerate(frames):
        if restore_at is not None and t == restore_at - 2:
            saved = restored_copy(s_eager)
        if t == restore_at:
            s_static, s_eager = restored_copy(saved), restored_copy(saved)
        f = step_input(cfg, registry, raw, packed, device)
        s_static, r_s, d_s = static(s_static, f)
        s_eager, r_e, d_e = eager(s_eager, f)
        parted.append(parted_names((s_static, r_s, d_s, static.stages.rank_rng.gen),
                              (s_eager, r_e, d_e, eager.stages.rank_rng.gen)))
        diags.append({k: int(v) for k, v in d_s._asdict().items()})
        kept &= s_static is first and {n: x.data_ptr() for n, x in _leaves(s_static)} == ptrs
    return {"parted": parted, "diags": diags, "addresses_kept": kept,
            "split": static.static.split}


def static_audit_case(device, cfg, params, frames, packed, seed, group):
    """The static path's parts on the CPU under a dispatch-mode audit, the
    stand-in for a capture: two frames, then on the third the parts that the
    card captures (``_fit`` and ``_body``, the collectives inside) must run
    no op that reads the device to the host, and the bridge only the SVD's.
    Then a frame of another shape must raise.  Returns each part's hits and
    collectives, whether the step was split, and the error of the last
    frame."""
    registry = LabelRegistry.default()
    D, rank = dist.get_world_size(group), dist.get_rank(group)
    step = build_shard_step(cfg, params, registry, group=group, packed=packed)
    state = shard_state(cfg, init_map_state(cfg, seed, device), rank, D)
    for raw in frames[:2]:
        state, _r, _d = step(state, step_input(cfg, registry, raw, packed, device))
    static = step.static
    parts = ("_fit", "_bridge", "_body") if static.split else ("_body",)
    audits = {name: HostSyncAudit() for name in parts}

    def audited(name, fn):
        def run(*args):
            with audits[name]:
                return fn(*args)
        return run

    for name in parts:
        setattr(static, name, audited(name, getattr(static, name)))
    state, _r, _d = step(state, step_input(cfg, registry, frames[2], packed, device))
    f = step_input(cfg, registry, frames[3], packed, device)
    wrong = f[:-1] if packed else f._replace(depth=f.depth[:-1])
    try:
        step(state, wrong)
        error = None
    except ValueError as err:
        error = str(err)
    return {"split": static.split, "error": error,
            "hits": {n: sorted(a.hits) for n, a in audits.items()},
            "collectives": {n: sorted(a.collectives) for n, a in audits.items()}}


def route_case(device, seed, cap, group):
    """``_route`` and ``_route_back`` on seeded entries: each rank sends N
    entries (an f32 and an i32 field) with random destinations, some of
    them invalid or out of range, and echoes each received entry back with
    its value + 1 and the receiving rank."""
    D, rank = dist.get_world_size(group), dist.get_rank(group)
    rng = np.random.RandomState(seed * 100 + rank)
    n = 40
    x = rng.randn(n).astype(np.float32)
    k = rng.randint(-1000, 1000, n).astype(np.int32)
    dest = rng.randint(-1, D + 1, n).astype(np.int64)
    valid = rng.rand(n) < 0.8
    T = lambda a: torch.from_numpy(a).to(device)
    routed = shard_step._route({"x": T(x), "k": T(k)}, T(valid), T(dest), D, cap, group)
    got = routed.fields
    back = shard_step._route_back(
        {"x1": got["x"] + 1.0, "r": torch.full_like(got["k"], rank)}, routed.send_slot, group)
    cpu = lambda t: t.cpu().numpy()
    return dict(x=x, k=k, dest=dest, valid=valid, send_slot=cpu(routed.send_slot),
                overflow=int(routed.overflow), recv_x=cpu(got["x"]), recv_k=cpu(got["k"]),
                recv_valid=cpu(routed.recv_valid), back_x1=cpu(back["x1"]), back_r=cpu(back["r"]))


def halo_case(device, S, W, rpd, R, seed, group):
    """Both halo exchanges on a seeded whole table of rpd*D rows: this rank
    holds its owned rows, gets its neighbours' edge rows, and returns the
    extended table and ck planes."""
    D, rank = dist.get_world_size(group), dist.get_rank(group)
    full = whole_table(S, rpd * D, W, seed)
    own = lambda a: torch.from_numpy(np.ascontiguousarray(a[..., rank * rpd : (rank + 1) * rpd, :])).to(device)
    t = PixelTable(px=own(full["px"]), py=own(full["py"]), pz=own(full["pz"]),
                   weight=own(full["weight"]), meta=own(full["meta"]),
                   dropped=torch.zeros((), dtype=torch.int64, device=device))
    ext = shard_step._exchange_table_halo(t, rank, D, R, group)
    # pass A's output over the extended rows: the owned rows are the whole
    # ck's, the halo rows hold values the exchange must replace
    ck = torch.full((rpd + 2 * R, W), -7.0, device=device)
    ck[R : R + rpd] = own(full["ck"])
    ck = shard_step._exchange_ck_halo(ck, rank, D, rpd, R, group)
    cpu = lambda a: a.cpu().numpy()
    return dict(px=cpu(ext.px), py=cpu(ext.py), pz=cpu(ext.pz), weight=cpu(ext.weight),
                meta=cpu(ext.meta), ck=cpu(ck))


def whole_table(S, H, W, seed):
    """A seeded table [S, H, W] (a third of the slots filled) and ck [H, W]."""
    rng = np.random.RandomState(seed)
    occ = rng.rand(S, H, W) < 0.35
    f = lambda: np.where(occ, rng.randn(S, H, W), 0).astype(np.float32)
    return dict(px=f(), py=f(), pz=f(), weight=f(),
                meta=np.where(occ, rng.randint(0, 1 << 20, (S, H, W)), -1).astype(np.int32),
                ck=rng.rand(H, W).astype(np.float32))


def run_cases(device, cases):
    """Every case of ``cases`` (name -> (ranks, function name, arguments))
    on a group of the first ``ranks`` ranks; every rank creates every group,
    in the same order.  Returns name -> this rank's result (None where the
    rank is not in the case's group)."""
    rank = dist.get_rank()
    groups = {}
    for ranks, _fn, _args in cases.values():
        if ranks not in groups:
            groups[ranks] = dist.new_group(list(range(ranks)))
    out = {}
    for name, (ranks, fn, args) in cases.items():
        out[name] = globals()[fn](device, *args, groups[ranks]) if rank < ranks else None
    return out
