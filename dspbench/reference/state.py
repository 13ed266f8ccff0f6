"""Map state as dataclasses of tensors.

The PyTorch counterpart of ``semantic_dsp_map_tpu/state.py``.  Particle
storage is flat ``[V*K]`` (voxel-major, K slots per voxel); ops take
``tensor.view(V, K)`` where they need the voxel axis.

Differences from the JAX state, all compared by value in the tests:
  - ``track`` is int32 (the JAX state stores uint16; torch's uint16 has no
    arithmetic kernels);
  - the RNG is a ``torch.Generator`` instead of a ``jax.random`` key;
  - the frame step updates the particle store IN PLACE (the store is ~1.5 GB
    at VKITTI2 scale), so a state passed to the step must not be reused.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import MapConfig

# Particle status codes (buffer.h:43-50).
STATUS_INVALID = 0
STATUS_UPDATED = 1
STATUS_REGULAR_BORN = 2
STATUS_GUESSED_BORN = 3


@dataclasses.dataclass
class Particles:
    """SoA particle storage, flat shape [V*K]."""

    px: torch.Tensor      # f32 global-frame position x
    py: torch.Tensor      # f32
    pz: torch.Tensor      # f32
    weight: torch.Tensor  # f32
    label: torch.Tensor   # u8 semantic label id
    track: torch.Tensor   # i32 instance / track id (< 65536)
    status: torch.Tensor  # u8 STATUS_*
    forget: torch.Tensor  # u8 forgetting counter
    stamp: torch.Tensor   # i32 birth/update time stamp


@dataclasses.dataclass
class ScrollState:
    """Ego-centric ring-buffer scroll state (buffer.h:97-120)."""

    ego_pos: torch.Tensor        # f32[3]
    map_center: torch.Tensor     # f32[3]
    moved_steps: torch.Tensor    # i32[3]
    equiv_steps: torch.Tensor    # i32[3]
    axis_stamp_x: torch.Tensor   # i32[Nx]
    axis_stamp_y: torch.Tensor   # i32[Ny]
    axis_stamp_z: torch.Tensor   # i32[Nz]


@dataclasses.dataclass
class ObjectTable:
    """Fixed-capacity object layer; leading dim O = cfg.max_objects."""

    valid: torch.Tensor              # bool[O]
    track_id: torch.Tensor           # i32[O]
    label: torch.Tensor              # i32[O]
    last_obs_step: torch.Tensor      # i32[O]
    obs_count: torch.Tensor          # i32[O]
    moved_probability: torch.Tensor  # f32[O]
    moving: torch.Tensor             # bool[O]
    has_moved_record: torch.Tensor   # bool[O]
    tmatrix: torch.Tensor            # f32[O, 4, 4]
    has_tmatrix: torch.Tensor        # bool[O]
    reference_point: torch.Tensor    # f32[O, 3]
    to_match_templates: torch.Tensor # bool[O]
    to_match_previous: torch.Tensor  # bool[O]
    win_tmatrix: torch.Tensor        # f32[O, W, 4, 4]
    win_dt: torch.Tensor             # f32[O, W]
    win_ref: torch.Tensor            # f32[O, W, 3]
    win_stamp: torch.Tensor          # i32[O, W]
    win_count: torch.Tensor          # i32[O]
    velocity: torch.Tensor           # f32[O, 3]
    vel_valid: torch.Tensor          # bool[O]
    last_kpts: torch.Tensor          # f32[O, 4, 3]
    last_kpts_time: torch.Tensor     # f32[O]
    has_last_kpts: torch.Tensor      # bool[O]
    key_kpts: torch.Tensor           # f32[O, 4, 3]
    key_kpts_time: torch.Tensor      # f32[O]


@dataclasses.dataclass
class MapState:
    particles: Particles
    voxel_stamp: torch.Tensor      # i32[V] observation stamp (0 = never)
    scroll: ScrollState
    objects: ObjectTable
    global_time: torch.Tensor      # i32 scalar frame counter
    prev_frame_time: torch.Tensor  # f32 scalar
    rng: torch.Generator


def resolve_device(device=None) -> torch.device:
    """The device rule of the package: ``None`` means the card
    (``torch.device("cuda")``); the CPU is used only when asked for by name.
    Without a CUDA device ``None`` raises: there is no silent step down."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device found and no device given: the map runs on the card by '
            'default; pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda")


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)`` for a Python number
    or a short sequence of them, made by fill kernels on ``device``.
    ``torch.tensor`` copies from host memory, which on the card synchronizes
    the stream, and a CUDA graph's capture refuses that (``step_graph``).
    Each value is rounded to ``dtype`` as ``torch.tensor`` rounds it."""
    if isinstance(values, (bool, int, float)):
        return torch.full((), values, dtype=dtype, device=device)
    return torch.stack([torch.full((), v, dtype=dtype, device=device) for v in values])


def init_particles(cfg: MapConfig, device=None) -> Particles:
    device = resolve_device(device)
    n = cfg.num_voxels * cfg.slots_per_voxel
    z = lambda dtype: torch.zeros(n, dtype=dtype, device=device)
    return Particles(
        px=z(torch.float32), py=z(torch.float32), pz=z(torch.float32),
        weight=z(torch.float32), label=z(torch.uint8), track=z(torch.int32),
        status=z(torch.uint8), forget=z(torch.uint8), stamp=z(torch.int32),
    )


def init_scroll(cfg: MapConfig, device=None) -> ScrollState:
    device = resolve_device(device)
    z = lambda n, dtype: torch.zeros(n, dtype=dtype, device=device)
    return ScrollState(
        ego_pos=z(3, torch.float32),
        map_center=z(3, torch.float32),
        moved_steps=z(3, torch.int32),
        equiv_steps=z(3, torch.int32),
        axis_stamp_x=z(cfg.nx, torch.int32),
        axis_stamp_y=z(cfg.ny, torch.int32),
        axis_stamp_z=z(cfg.nz, torch.int32),
    )


def init_objects(cfg: MapConfig, device=None) -> ObjectTable:
    device = resolve_device(device)
    O, W = cfg.max_objects, cfg.transform_window
    f32, i32 = torch.float32, torch.int32
    z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    eye = lambda shape: torch.eye(4, dtype=f32, device=device).expand(*shape, 4, 4).clone()
    return ObjectTable(
        valid=z(O, torch.bool),
        track_id=torch.full((O,), -1, dtype=i32, device=device),
        label=z(O, i32),
        last_obs_step=z(O, i32),
        obs_count=z(O, i32),
        moved_probability=torch.full((O,), 0.5, dtype=f32, device=device),
        moving=z(O, torch.bool),
        has_moved_record=z(O, torch.bool),
        tmatrix=eye((O,)),
        has_tmatrix=z(O, torch.bool),
        reference_point=z((O, 3), f32),
        to_match_templates=z(O, torch.bool),
        to_match_previous=z(O, torch.bool),
        win_tmatrix=eye((O, W)),
        win_dt=z((O, W), f32),
        win_ref=z((O, W, 3), f32),
        win_stamp=z((O, W), i32),
        win_count=z(O, i32),
        velocity=z((O, 3), f32),
        vel_valid=z(O, torch.bool),
        last_kpts=z((O, 4, 3), f32),
        last_kpts_time=z(O, f32),
        has_last_kpts=z(O, torch.bool),
        key_kpts=z((O, 4, 3), f32),
        key_kpts_time=z(O, f32),
    )


def make_generator(seed: int, device=None) -> torch.Generator:
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(seed)
    return g


def init_map_state(cfg: MapConfig, seed: int = 0, device=None) -> MapState:
    """A cleared map (operations.h:684-767 initialize/clear analog).
    ``device=None`` means the card (:func:`resolve_device`)."""
    device = resolve_device(device)
    return MapState(
        particles=init_particles(cfg, device),
        voxel_stamp=torch.zeros(cfg.num_voxels, dtype=torch.int32, device=device),
        scroll=init_scroll(cfg, device),
        objects=init_objects(cfg, device),
        global_time=torch.zeros((), dtype=torch.int32, device=device),
        prev_frame_time=torch.zeros((), dtype=torch.float32, device=device),
        rng=make_generator(seed, device),
    )
