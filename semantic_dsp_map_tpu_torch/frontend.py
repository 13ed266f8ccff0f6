"""Host-side frame ingest: MaskKpts-style inputs -> fixed-shape numpy arrays.

A copy of the numpy host side of ``semantic_dsp_map_tpu/frontend.py`` (which
cannot be imported without JAX); ``pack_frame`` produces the same bytes
(tests/test_torch_frame.py).  The ROS node of the reference converts
``mask_kpts_msgs/MaskGroup`` into ``vector<MaskKpts>`` (src/mapping.cpp:203-251)
and ``generateLabeledPointCloud`` fuses the masks into a per-pixel track-id
raster (pointcloud_tools.h:116-215).  The device-side decode of the packed
buffer is ``map.unpack_frame``.

In the ZED2/bbox3d mode ``build_frame_input`` also builds the dense
per-track bbox tables of the bbox gate; ``pack_frame`` carries the boxes
per instance and ``map.unpack_frame`` rebuilds the tables on the device.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple, Optional, Sequence

import numpy as np

from .config import KEYPOINTS_BBOX3D, MapConfig
from .labels import BACKGROUND_INSTANCE_ID, LabelRegistry


@dataclasses.dataclass
class MaskKpts:
    """Python mirror of the reference's MaskKpts input struct
    (tracking_result_handler.h:15-26; wire schema
    script/mmseg/mask_kpts_msgs/msg/_MaskKpts.py:17-24).

    The static background is one entry with label == "static" and
    track_id == 65535 whose mask pixels hold (label_id - 1)
    (docs/custom_files.md:43-47).
    """

    track_id: int
    label: str
    mask: Optional[np.ndarray] = None          # uint8 [H, W]
    kpts_current: Optional[np.ndarray] = None  # f64/f32 [n, 3]
    kpts_previous: Optional[np.ndarray] = None # f64/f32 [n, 3]
    bbox: Optional[tuple] = None               # (x1, y1, x2, y2)


class FrameInput(NamedTuple):
    """One frame's arrays: numpy on the host (build_frame_input) or tensors
    on the device (map.unpack_frame)."""

    depth: np.ndarray              # f32[H, W] (BOOST-resized)
    track_raster: np.ndarray       # i32[H, W]
    track_label_table: np.ndarray  # i32[65536]
    inst_valid: np.ndarray         # bool[I]
    inst_track: np.ndarray         # i32[I]
    inst_label: np.ndarray         # i32[I]
    kpts_curr: np.ndarray          # f32[I, Kp, 3]
    kpts_prev: np.ndarray          # f32[I, Kp, 3]
    kpts_count: np.ndarray         # i32[I]
    inst_bbox_min: np.ndarray      # f32[65536, 3] (only used in bbox3d mode)
    inst_bbox_max: np.ndarray      # f32[65536, 3]
    cam_pos: np.ndarray            # f32[3]
    cam_quat: np.ndarray           # f32[4] (w, x, y, z)
    time: np.ndarray               # f32 scalar (seconds, relative epoch)


def manual_resize(src: np.ndarray, scale: float) -> np.ndarray:
    """Nearest-neighbor resize matching manualResize
    (pointcloud_tools.h:1104-1133, the Jetson cv::resize workaround):
    dst[i, j] = src[int(i/scale), int(j/scale)] with bounds clamping."""
    new_rows = int(src.shape[0] * scale)
    new_cols = int(src.shape[1] * scale)
    inv = 1.0 / scale
    ri = np.minimum((np.arange(new_rows) * inv).astype(np.int64), src.shape[0] - 1)
    ci = np.minimum((np.arange(new_cols) * inv).astype(np.int64), src.shape[1] - 1)
    return src[np.ix_(ri, ci)]


#: Static-mask pixels looked up by one ``np.take``: it copies its indices
#: to ``intp`` first (8 bytes a pixel), and a chunk's copy stays at 64 KiB,
#: under glibc's 128 KiB mmap threshold, so it comes from the heap.
TAKE_PIXELS = 8192


class Instances(NamedTuple):
    """A frame's per-instance fields, in the packed buffer's order (the
    bboxes PER INSTANCE, margin applied)."""

    track: np.ndarray       # i32[I] (-1 = empty slot)
    label: np.ndarray       # i32[I]
    kpts_count: np.ndarray  # i32[I]
    has_bbox: np.ndarray    # i32[I] (0/1)
    bbox_min: np.ndarray    # f32[I, 3]
    bbox_max: np.ndarray    # f32[I, 3]
    kpts_curr: np.ndarray   # f32[I, Kp, 3]
    kpts_prev: np.ndarray   # f32[I, Kp, 3]


def _sized(cfg: MapConfig, image: np.ndarray) -> np.ndarray:
    """An input image at the map's size: BOOST mode resizes what is not."""
    if cfg.boost_mode and image.shape != (cfg.height, cfg.width):
        return manual_resize(image, cfg.image_rescale)
    return image


def _reallocate_track_ids(registry: LabelRegistry, masks: Sequence[MaskKpts]) -> list:
    """Track-id modulo reallocation (semantic_dsp_map.h:178-186), on the
    MaskKpts themselves."""
    max_movable = registry.max_movable_instance_id
    masks = list(masks)
    for mk in masks:
        if mk.label != "static" and mk.track_id > max_movable:
            mk.track_id = mk.track_id % max_movable
    return masks


def _fuse_masks(cfg: MapConfig, registry: LabelRegistry, masks: Sequence[MaskKpts],
                raster: np.ndarray, scratch: np.ndarray) -> None:
    """Fuse static + instance masks into ``raster`` (i32 or u16 [H, W]) in
    place (pointcloud_tools.h:116-215); ``scratch`` is a bool[H, W] work
    image.  A uint8 static mask and every instance mask are fused with no
    array of the image's size allocated."""
    H, W = raster.shape
    static_table = registry.static_pixel_value_to_instance_table()

    # Static mask first (there should be only one, pointcloud_tools.h:122-143):
    # pixel value + 1 through the table; without one, Background.
    for mk in masks:
        if mk.label == "static" and mk.mask is not None:
            m = _sized(cfg, mk.mask)
            if m.dtype == np.uint8 and m.shape == (H, W):
                lut = static_table[np.clip(np.arange(256) + 1, 0, 255)].astype(raster.dtype)
                rows = max(1, TAKE_PIXELS // W)
                for r in range(0, H, rows):
                    np.take(lut, m[r : r + rows], out=raster[r : r + rows], mode="clip")
            else:
                raster[...] = static_table[np.clip(m.astype(np.int32) + 1, 0, 255)]
            break
    else:
        raster.fill(BACKGROUND_INSTANCE_ID)

    # Movable instances overlay wherever their mask is positive
    # (pointcloud_tools.h:202-212).
    if cfg.consider_instance:
        limits = np.iinfo(raster.dtype)
        for mk in masks:
            if mk.label != "static" and mk.mask is not None:
                if not limits.min <= mk.track_id <= limits.max:
                    raise ValueError(f"track id {mk.track_id} of a {mk.label!r} mask: the "
                                     f"raster holds {raster.dtype} ids")
                np.greater(_sized(cfg, mk.mask), 0, out=scratch)
                np.copyto(raster, raster.dtype.type(mk.track_id), where=scratch)


def rasterize_masks(
    cfg: MapConfig,
    registry: LabelRegistry,
    masks: Sequence[MaskKpts],
) -> np.ndarray:
    """Fuse static + instance masks into the per-pixel track-id raster
    (pointcloud_tools.h:116-215).  Returns i32[H, W]."""
    raster = np.empty((cfg.height, cfg.width), np.int32)
    _fuse_masks(cfg, registry, masks, raster, np.empty(raster.shape, bool))
    return raster


def _fill_instances(cfg: MapConfig, registry: LabelRegistry, masks: Sequence[MaskKpts],
                    inst: Instances) -> None:
    """Write the fixed-shape instance fields in place, every slot: the
    movers in mask order, then empty slots."""
    inst.track.fill(-1)
    inst.label.fill(-1)
    for field in inst[2:]:
        field.fill(0)
    I, Kp = inst.kpts_curr.shape[:2]
    slot = 0
    for mk in masks:
        if mk.label == "static":
            continue
        lid = registry.label_to_id.get(mk.label, -1)
        # kpts size sanity (src/mapping.cpp:243-247): drop mismatched entries.
        kc = np.asarray(mk.kpts_current, np.float32).reshape(-1, 3) if mk.kpts_current is not None else np.zeros((0, 3), np.float32)
        kp = np.asarray(mk.kpts_previous, np.float32).reshape(-1, 3) if mk.kpts_previous is not None else np.zeros((0, 3), np.float32)
        if cfg.keypoint_mode != KEYPOINTS_BBOX3D and kc.shape[0] != kp.shape[0]:
            continue
        if slot >= I:
            continue
        n = min(kc.shape[0], Kp)
        inst.track[slot] = mk.track_id
        inst.label[slot] = lid
        inst.kpts_curr[slot, :n] = kc[:n]
        inst.kpts_prev[slot, : min(kp.shape[0], Kp)] = kp[:Kp]
        inst.kpts_count[slot] = n
        # ZED2 bbox gate (pointcloud_tools.h:178-199): keypoint AABB with a
        # 1 m margin, keyed by track id.
        if cfg.keypoint_mode == KEYPOINTS_BBOX3D and n > 0 and 0 <= mk.track_id < 65536:
            inst.bbox_min[slot] = kc[:n].min(axis=0) - 1.0
            inst.bbox_max[slot] = kc[:n].max(axis=0) + 1.0
            inst.has_bbox[slot] = 1
        slot += 1


def _ingest(
    cfg: MapConfig,
    registry: LabelRegistry,
    depth: np.ndarray,
    masks: Sequence[MaskKpts],
):
    """Shared host-side ingest of the unpacked path: BOOST resize, track-id
    modulo reallocation, mask fusion, fixed-shape instance arrays.

    Returns (depth f32[H,W], raster i32[H,W], Instances)."""
    masks = _reallocate_track_ids(registry, masks)
    depth = np.ascontiguousarray(_sized(cfg, depth), dtype=np.float32)
    raster = rasterize_masks(cfg, registry, masks)
    I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints
    inst = Instances(
        track=np.empty(I, np.int32), label=np.empty(I, np.int32),
        kpts_count=np.empty(I, np.int32), has_bbox=np.empty(I, np.int32),
        bbox_min=np.empty((I, 3), np.float32), bbox_max=np.empty((I, 3), np.float32),
        kpts_curr=np.empty((I, Kp, 3), np.float32), kpts_prev=np.empty((I, Kp, 3), np.float32),
    )
    _fill_instances(cfg, registry, masks, inst)
    return depth, raster, inst


def static_label_table(registry: LabelRegistry) -> np.ndarray:
    """track -> label base table: reserved static ids map via the registry,
    everything else Background (pointcloud_tools.h:275-282)."""
    table = np.zeros(65536, dtype=np.int32)
    for label, instid in registry.static_label_to_instance.items():
        lid = registry.label_to_id.get(label, 0)
        table[instid] = lid
    return table


def build_frame_input(
    cfg: MapConfig,
    registry: LabelRegistry,
    depth: np.ndarray,
    masks: Sequence[MaskKpts],
    cam_pos,
    cam_quat,
    time: float = 0.0,
) -> FrameInput:
    """Full per-frame ingest to the unpacked FrameInput (dense tables on
    host).  The production transfer path is :func:`pack_frame` — one
    contiguous buffer, with the dense tables rebuilt on device."""
    depth, raster, inst = _ingest(cfg, registry, depth, masks)

    table = static_label_table(registry)
    bbox_min = np.full((65536, 3), -np.inf, np.float32)
    bbox_max = np.full((65536, 3), np.inf, np.float32)
    I = cfg.max_instances_per_frame
    for slot in range(I):
        tid = int(inst.track[slot])
        if tid < 0:
            continue
        if inst.label[slot] >= 0 and tid < 65536:
            table[tid] = inst.label[slot]
        if inst.has_bbox[slot]:
            bbox_min[tid] = inst.bbox_min[slot]
            bbox_max[tid] = inst.bbox_max[slot]

    return FrameInput(
        depth=depth,
        track_raster=raster,
        track_label_table=table,
        inst_valid=inst.track >= 0,
        inst_track=np.maximum(inst.track, 0),
        inst_label=inst.label,
        kpts_curr=inst.kpts_curr,
        kpts_prev=inst.kpts_prev,
        kpts_count=inst.kpts_count,
        inst_bbox_min=bbox_min,
        inst_bbox_max=bbox_max,
        cam_pos=np.asarray(cam_pos, np.float32).reshape(3),
        cam_quat=np.asarray(cam_quat, np.float32).reshape(4),
        time=np.float32(time),
    )


# ---------------------------------------------------------------------------
# Packed single-buffer transfer path
# ---------------------------------------------------------------------------
#
# One contiguous int32 buffer per frame, decoded and expanded into the
# dense lookup tables on the device (map.unpack_frame).  The format is the
# JAX package's, so both packages take the same bytes.
#
# Word layout (all 4-byte words; f32 values bitcast):
#   [0:3]   cam_pos, [3:7] cam_quat, [7] time
#   [8 : 8+HW]            depth f32 bits
#   [.. : ..+ceil(HW/2)]  track raster, two u16 per word (lo, hi)
#   [.. : ..+I]           inst_track (-1 = empty slot)
#   [.. : ..+I]           inst_label
#   [.. : ..+I]           kpts_count
#   [.. : ..+I]           has_bbox (0/1)
#   [.. : ..+I*3]         bbox_min f32 bits   (margin applied)
#   [.. : ..+I*3]         bbox_max f32 bits
#   [.. : ..+I*Kp*3]      kpts_curr f32 bits
#   [.. : ..+I*Kp*3]      kpts_prev f32 bits


def packed_frame_words(cfg: MapConfig) -> int:
    HW = cfg.height * cfg.width
    I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints
    return 8 + HW + (HW + 1) // 2 + 4 * I + 6 * I + 2 * I * Kp * 3


class PackedFrame:
    """A packed frame buffer (``buf``, int32[packed_frame_words]) with its
    fields as views, packed in place frame after frame (:meth:`pack`).
    The map holds one for ``update()``; :func:`pack_frame` packs into a new
    one.  Packing a uint8 static mask allocates no array of the image's
    size: the raster is written through the ``uint16`` view of its words
    (on a little-endian host, ``lo | hi << 16`` is that view)."""

    def __init__(self, cfg: MapConfig):
        if sys.byteorder != "little":
            raise NotImplementedError("the raster words are written as little-endian u16 pairs")
        H, W = cfg.height, cfg.width
        I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints
        self.shape = (H, W, I, Kp)
        self.buf = np.empty(packed_frame_words(cfg), np.int32)
        self.scratch = np.empty((H, W), bool)
        fields, at = [], 0
        for n in (8, H * W, (H * W + 1) // 2, I, I, I, I, I * 3, I * 3, I * Kp * 3, I * Kp * 3):
            fields.append(self.buf[at : at + n])
            at += n
        head, depth, raster, *inst = fields
        self.head = head.view(np.float32)
        self.depth = depth.view(np.float32).reshape(H, W)
        pixels = raster.view(np.uint16)
        self.raster, self.tail = pixels[: H * W].reshape(H, W), pixels[H * W :]
        self.inst = Instances(*inst[:4], *(f.view(np.float32).reshape(-1, 3) for f in inst[4:6]),
                              *(f.view(np.float32).reshape(I, Kp, 3) for f in inst[6:]))

    def fits(self, cfg: MapConfig) -> bool:
        """Whether ``cfg``'s frames have this buffer's shape."""
        return self.shape == (cfg.height, cfg.width, cfg.max_instances_per_frame,
                              cfg.max_keypoints)

    def pack(self, cfg: MapConfig, registry: LabelRegistry, depth: np.ndarray,
             masks: Sequence[MaskKpts], cam_pos, cam_quat, time: float = 0.0) -> np.ndarray:
        """Pack one frame into ``buf`` (every word written) and return it."""
        masks = _reallocate_track_ids(registry, masks)
        self.head[0:3] = np.asarray(cam_pos, np.float32).reshape(3)
        self.head[3:7] = np.asarray(cam_quat, np.float32).reshape(4)
        self.head[7] = np.float32(time)
        depth = _sized(cfg, np.asarray(depth))
        np.copyto(self.depth, depth.reshape(self.depth.shape), casting="unsafe")
        _fuse_masks(cfg, registry, masks, self.raster, self.scratch)
        self.tail.fill(0)
        _fill_instances(cfg, registry, masks, self.inst)
        return self.buf


def pack_frame(
    cfg: MapConfig,
    registry: LabelRegistry,
    depth: np.ndarray,
    masks: Sequence[MaskKpts],
    cam_pos,
    cam_quat,
    time: float = 0.0,
) -> np.ndarray:
    """One-buffer frame encoding (int32[packed_frame_words]), in a new
    buffer."""
    return PackedFrame(cfg).pack(cfg, registry, depth, masks, cam_pos, cam_quat, time)
