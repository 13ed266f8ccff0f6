"""Static configuration of the PyTorch port of the semantic DSP map.

A field-for-field copy of ``semantic_dsp_map_tpu/config.py`` (held equal by
tests/test_torch_frame.py), kept here because importing the JAX package
pulls in JAX.  The ``use_pallas_*`` field names are kept so the two configs
stay equal; in this package they select the hand-written CUDA kernels on a
CUDA device.

This replaces the reference's three-tier config system
(compile-time ``include/settings/settings.h`` macros, runtime YAML read by
``src/mapping.cpp:96-132``, and the four mutable global flags of
``include/settings/external_settings.h:14-17``) with a single frozen dataclass.

All shape-bearing fields (grid exponents, slots/voxel, image size) are Python
ints captured at trace time, so every jitted kernel specializes on them exactly
like the reference specializes at compile time via ``#define SETTING``.

Reference parity notes (file:line cites into the reference implementation):
  - grid exponents / voxel size / camera intrinsics per dataset mode:
    include/settings/settings.h:32-124
  - BOOST half-resolution mode: include/settings/settings.h:135-144
  - newborn weight / min-rightly-updated pdf / depth-noise stddev constants:
    include/settings/settings.h:147-150
  - runtime filter parameters (YAML keys): src/mapping.cpp:96-132 and
    cfg/options*.yaml
  - runtime feature flags: include/settings/external_settings.h:14-17
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# ---------------------------------------------------------------------------
# Constants shared with the reference
# ---------------------------------------------------------------------------

#: Initial weight of a newborn occupancy particle (settings.h:147).
PARTICLE_OCC_INIT_WEIGHT = 0.05

#: Minimum pdf value for a particle to count as "rightly updated" by an
#: observation with matching track id; drives the forgetting reset
#: (settings.h:149, semantic_dsp_map.h:1094).
MIN_RIGHTLY_UPDATED_PDF = 0.1

#: The reference's Gaussian "PDF" table is built with
#: ``1/sqrt(2*M_PI_2f32) * exp(-x^2/2)`` where ``M_PI_2f32`` is pi/2, i.e. the
#: normalizing constant is 1/sqrt(pi), not 1/sqrt(2*pi)
#: (basic_algorithms.h:456-459).  The constant matters relative to the additive
#: clutter term ``noise_number`` and the missed-detection term, so we reproduce
#: it faithfully instead of "fixing" it.
GAUSSIAN_PDF_COEF = 1.0 / math.sqrt(math.pi)

#: |z| beyond which the reference LUT returns 1e-9 (basic_algorithms.h:420).
GAUSSIAN_PDF_Z_CLIP = 9.9


#: Hard cap used when incrementing a particle's forget counter
#: (semantic_dsp_map.h:1111 uses a literal 5 independent of max_forget_count).
FORGET_COUNT_INCREMENT_CAP = 5

#: Movement modes for the object-layer Bayesian moving/static decision.
#: The reference hardwires these per dataset mode (object_layer.h:483-511):
#: SETTING 0 -> never moving, SETTING 1 -> always moving, 2/3 -> Bayesian.
MOVEMENT_NEVER = 0
MOVEMENT_ALWAYS = 1
MOVEMENT_BAYESIAN = 2

#: Keypoint interpretation for the object layer (semantic_dsp_map.h:338-342):
#: superpoint = matched feature points (>=5 needed, RANSAC 100 iters);
#: bbox3d = 4 corners of a 3D detection (ZED2 path, 2 RANSAC iters,
#: movement observed from reference-corner drift).
KEYPOINTS_SUPERPOINT = 0
KEYPOINTS_BBOX3D = 1


@dataclasses.dataclass(frozen=True)
class FilterParams:
    """Runtime (non-shape) parameters of the SMC-PHD filter.

    Mirrors the YAML-tunable parameters of the reference
    (src/mapping.cpp:109-132, defaults semantic_dsp_map.h:25-43).
    These are baked into the jitted step as Python floats; changing them
    retraces (cheap, and matches the reference's restart-to-change workflow).
    """

    detection_probability: float = 0.95
    noise_number: float = 0.1
    nb_ptc_num_per_point: int = 3
    occupancy_threshold: float = 0.2
    max_observation_lost_time: int = 5
    forgetting_rate: float = 1.0
    max_forget_count: int = 5
    id_transition_probability: float = 0.1
    match_score_threshold: float = 0.3
    bayesian_movement_distance_threshold: float = 0.1
    bayesian_movement_probability_threshold: float = 0.69
    bayesian_movement_increment: float = 0.1
    bayesian_movement_decrement: float = 0.15
    prediction_stddev: float = 0.05
    depth_noise_model_first_order: float = 0.0
    depth_noise_model_zero_order: float = 0.1

    # Feature flags (external_settings.h:14-17).
    if_consider_depth_noise: bool = False
    if_use_independent_filter: bool = False
    if_use_template_matching: bool = False
    #: Use the 4-neighborhood denoise/inference occupancy reduction
    #: (operations.h:457-600).  The reference ships this variant as dead code
    #: (no call site, no YAML key); exposed here for parity/experiments.
    if_use_neighbor_smoothed_occupancy: bool = False
    # Pignistic probability is effectively dead in the reference (aborted as
    # "TOO SLOW", semantic_dsp_map.h:1250-1253); kept for config parity only.
    if_use_pignistic_probability: bool = False

    # Output options (semantic_dsp_map.h:130-134).
    if_out_evaluation_format: bool = False
    visualize_with_zero_center: bool = False
    if_output_freespace: bool = False


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Static (shape-bearing) map configuration — the SETTING analog."""

    # Grid exponents: the grid is 2^nx x 2^ny x 2^nz voxels
    # (settings.h:33-35 et al).
    voxel_num_axis_x_n: int = 8
    voxel_num_axis_y_n: int = 8
    voxel_num_axis_z_n: int = 8

    # log2 slots per voxel, including the implicit "time particle" slot the
    # reference reserves at index 0 (buffer.h:43-79).  We store the time
    # particle as a separate dense ``voxel_stamp`` array, so the number of
    # *real* particle slots is ``2^n - 1`` exactly like the reference.
    max_particle_num_per_voxel_n: int = 3

    voxel_size: float = 0.15

    # Camera intrinsics at full sensor resolution (settings.h:41-47 etc).
    camera_fx: float = 552.554261
    camera_fy: float = 552.554261
    camera_cx: float = 682.049453
    camera_cy: float = 238.769549
    image_width: int = 1408
    image_height: int = 376

    consider_instance: bool = False
    depth_range_min: float = 0.3
    depth_range_max: float = 30.0

    #: Depth-error 1-sigma coefficient used in the occlusion test
    #: (settings.h:150, operations.h:1387).
    depth_error_stddev_at_one_meter: float = 0.1

    #: BOOST half-resolution mode (settings.h:135-144): the effective camera
    #: is scaled by ``image_rescale`` and inputs are nearest-neighbor resized.
    boost_mode: bool = False
    image_rescale: float = 0.5

    #: PHD update neighborhood half-width in pixels (semantic_dsp_map.h:964-970:
    #: 5, or 3 in BOOST mode).
    phd_neighbor_half: Optional[int] = None

    #: Object-layer movement decision mode (see MOVEMENT_*).
    movement_mode: int = MOVEMENT_BAYESIAN

    #: Keypoint interpretation (see KEYPOINTS_*).
    keypoint_mode: int = KEYPOINTS_SUPERPOINT

    # ---- Capacity knobs (no reference analog; these bound the compacted
    # work buffers so shapes stay static and the step needs no host sync) ----

    #: Max visible (projected, unoccluded) particles processed per frame.
    max_visible_particles: int = 1 << 20

    #: Capacity of the per-frame active-block working set (ops/blocks.py):
    #: blocks of consecutive voxels holding any projectable particle are
    #: row-gathered into an [A, block_slots] working set.  Overflow is
    #: counted in StepDiagnostics (no silent loss).
    max_active_blocks: int = 8192

    #: Capacity of the pixel-sorted compact entry array feeding the PHD
    #: pixel table (candidates beyond this are dropped and counted).
    max_table_entries: int = 1 << 20

    #: Capacity of the insertion staging working set (ops/birth.py), in voxel
    #: blocks.  Separate from ``max_active_blocks`` (the observe-side knob) so
    #: the two caps can be tuned — and tested — independently.
    max_birth_blocks: int = 8192

    #: Capacity (in 512-voxel blocks) of the empty-voxel observation pass
    #: (the reference's "imaginary center particle" rule,
    #: operations.h:1414-1431).
    corner_gather_blocks: int = 4096

    #: Capacity of the rigid-move working set, in voxel blocks.  Movable
    #: particles live only where movable-label instances have been observed
    #: (round-4 probe: 48 blocks at VKITTI2 scale) — far below the observe
    #: working set.  Overflow is surfaced in StepDiagnostics.move_overflow.
    max_moving_blocks: int = 256

    #: Per-pixel particle-table slots for the PHD stencil (the reference's
    #: pyramid lists are unbounded; overflow drops the lightest particles for
    #: one frame — see ops/phd.py docstring).
    phd_pixel_table_slots: int = 12

    #: Sharded-step skew allowance: per-device working sets and all_to_all
    #: route buckets are sized at ``headroom_eff/D`` of the single-chip
    #: volume, where the margin scales with the relative load variance of a
    #: slab: ``headroom_eff = 1 + (headroom - 1) * (1 - 1/D)``
    #: (parallel/shard_step.py).  A D=2 half-grid slab averages over 4x the
    #: cells of a D=8 slab, so its load skew is proportionally smaller and
    #: needs less margin; at D=1 there is no routing and no margin.
    #: Weak-scaling efficiency >= 80% requires per-device compiled work
    #: <= ~1.25x the uniform 1/D share (compiled work scales with the static
    #: caps, not the live counts); skew beyond the margin is deferred/dropped
    #: for one frame and counted in the overflow diagnostics.
    shard_route_headroom: float = 1.2

    #: Minimum sharded route-bucket capacity (entries per (src, dst) pair).
    #: Small grids take the full route volume up to this floor so tests can
    #: never overflow; lowering it (with a small headroom) deliberately
    #: undersizes the buckets — tests/test_shard_step.py uses that to assert
    #: the overflow counters fire and the map stays sane under bucket
    #: pressure.
    shard_route_floor: int = 1024

    #: Run the PHD stencil passes as the CUDA kernels of ops/phd_cuda.py when
    #: the tensors are on a CUDA device.  The plain stencils of ops/phd.py
    #: run on the CPU and are the oracle the kernels are tested against.
    use_pallas_phd: bool = True

    #: Run the occupancy render reduction as the CUDA kernel of
    #: ops/render_cuda.py on a CUDA device; the plain reduction in
    #: ops/render.py runs on the CPU and is the kernel's oracle.
    use_pallas_render: bool = True

    #: Run observe's dense candidate pass and the movable-voxel scan as the
    #: CUDA kernels of ops/observe_cuda.py when the particle store is on a
    #: CUDA device; the plain scans of ops/observe.py run on the CPU and are
    #: the kernels' oracles.
    use_pallas_observe: bool = True

    #: Max per-frame newborn candidates actually considered is
    #: H*W*nb_ptc_num_per_point (dense, no cap needed); this caps the number
    #: of *moving-object* particles gathered for rigid moves per frame.
    #: Kept modest: the per-candidate compaction gathers run at TPU scalar
    #: rate, and a frame rarely moves more than a few cars' particles.
    max_moving_particles: int = 1 << 16

    #: Object table capacity (the reference uses unbounded hash maps over
    #: tens of objects; object_layer.h:345-373).
    max_objects: int = 64

    #: Transform window length (object_layer.h:206 max_window_size=5).
    transform_window: int = 5

    #: Max observed instances per frame and max keypoints per instance for the
    #: fixed-shape ingest arrays.
    max_instances_per_frame: int = 32
    max_keypoints: int = 64

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------

    def __post_init__(self):
        # Mirrors runSystemChecking (operations.h:54-58): particle indices
        # must fit in 31 bits.
        total_bits = (
            self.voxel_num_axis_x_n
            + self.voxel_num_axis_y_n
            + self.voxel_num_axis_z_n
            + self.max_particle_num_per_voxel_n
        )
        if total_bits > 31:
            raise ValueError(
                "grid exponents + particle exponent must be <= 31 bits, got %d"
                % total_bits
            )

    @property
    def nx(self) -> int:
        return 1 << self.voxel_num_axis_x_n

    @property
    def ny(self) -> int:
        return 1 << self.voxel_num_axis_y_n

    @property
    def nz(self) -> int:
        return 1 << self.voxel_num_axis_z_n

    @property
    def num_voxels(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def slots_per_voxel(self) -> int:
        """Number of real particle slots per voxel (2^n - 1; slot 0 of the
        reference's layout is the time particle, held separately here)."""
        return (1 << self.max_particle_num_per_voxel_n) - 1

    @property
    def fx(self) -> float:
        return self.camera_fx * self.image_rescale if self.boost_mode else self.camera_fx

    @property
    def fy(self) -> float:
        return self.camera_fy * self.image_rescale if self.boost_mode else self.camera_fy

    @property
    def cx(self) -> float:
        return self.camera_cx * self.image_rescale if self.boost_mode else self.camera_cx

    @property
    def cy(self) -> float:
        return self.camera_cy * self.image_rescale if self.boost_mode else self.camera_cy

    @property
    def width(self) -> int:
        return int(self.image_width * self.image_rescale) if self.boost_mode else self.image_width

    @property
    def height(self) -> int:
        return int(self.image_height * self.image_rescale) if self.boost_mode else self.image_height

    @property
    def neighbor_half(self) -> int:
        if self.phd_neighbor_half is not None:
            return self.phd_neighbor_half
        return 3 if self.boost_mode else 5

    @property
    def map_half_extent(self):
        """Half map extent per axis in meters (operations.h:735-737)."""
        return (
            (self.nx >> 1) * self.voxel_size,
            (self.ny >> 1) * self.voxel_size,
            (self.nz >> 1) * self.voxel_size,
        )

    @property
    def biggest_axis_n(self) -> int:
        return max(self.voxel_num_axis_x_n, self.voxel_num_axis_y_n, self.voxel_num_axis_z_n)

    @property
    def tan_half_fov_x(self) -> float:
        # operations.h:1249: tan(atan2(w/2, fx)) == (w/2)/fx.
        return (self.width / 2.0) / self.fx

    @property
    def tan_half_fov_y(self) -> float:
        return (self.height / 2.0) / self.fy
