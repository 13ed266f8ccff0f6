"""Real-sequence dataset readers (this package's own copy of
``semantic_dsp_map_tpu/datasets.py``: numpy only, no tensor work).

The reference validates by replaying recorded sequences into the ROS node
(README.md:60-70).  Its feeder scripts define the on-disk formats this module
reads natively, so the same data drives this framework without ROS:

  - KITTI-360 layout (script/tools/kitti360_data_reader.py:120-157,225-244):
    poses txt (17 numbers = frame idx + 4x4 cam0-to-world row-major, or
    13 numbers = frame idx + 3x4 IMU-to-world plus the fixed cam->IMU
    extrinsic), depth as .npy float32 meters, semantic label-id images as
    .png (mono, pixel = label_id - 1 per docs/custom_files.md:43-47).
  - Virtual KITTI 2 official layout (depth 16-bit PNG in centimeters,
    class-segmentation color PNG, instance-segmentation PNG, textgt
    pose/color tables).
  - Generic exported-tensor dirs: one ``.npz`` per frame (the non-ROS analog
    of script/tools/ros_topic_to_data.py's depth-npy/rgb-png export), holding
    exactly the arrays the ingest API takes.

All readers yield (depth, masks, cam_pos, cam_quat, time) tuples ready for
:meth:`semantic_dsp_map_tpu_torch.map.SemanticDSPMap.update`.  A frame written
by either package's ``save_npz_frame`` is read by the other's
``NpzSequence``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .frontend import MaskKpts
from .labels import LabelRegistry

#: cam0 -> IMU extrinsic for the 13-number KITTI-360 IMU pose format
#: (kitti360_data_reader.py:137-146).
KITTI360_CAM_TO_IMU = np.array(
    [
        [0.0371783278, -0.0986182135, 0.9944306009, 1.5752681039],
        [0.9992675562, -0.0053553387, -0.0378902567, 0.0043914093],
        [0.0090621821, 0.9951109327, 0.0983468786, -0.6500000000],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float64,
)


def rotation_to_quat_wxyz(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), Shepperd's method."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (r[2, 1] - r[1, 2]) / s
        y = (r[0, 2] - r[2, 0]) / s
        z = (r[1, 0] - r[0, 1]) / s
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        w = (r[2, 1] - r[1, 2]) / s
        x = 0.25 * s
        y = (r[0, 1] + r[1, 0]) / s
        z = (r[0, 2] + r[2, 0]) / s
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        w = (r[0, 2] - r[2, 0]) / s
        x = (r[0, 1] + r[1, 0]) / s
        y = 0.25 * s
        z = (r[1, 2] + r[2, 1]) / s
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        w = (r[1, 0] - r[0, 1]) / s
        x = (r[0, 2] + r[2, 0]) / s
        y = (r[1, 2] + r[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z], dtype=np.float64)
    return (q / np.linalg.norm(q)).astype(np.float32)


def read_kitti360_poses(path: str) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """Parse a KITTI-360 pose txt -> [(frame_idx, t f32[3], q_wxyz f32[4])].

    Handles both formats of kitti360_data_reader.py:120-157: 17 numbers
    (frame + 4x4 cam0-to-world) and 13 numbers (frame + 3x4 IMU-to-world,
    composed with the fixed cam->IMU extrinsic).
    """
    poses = []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if not vals:
                continue
            frame_idx = int(vals[0])
            nums = np.array([float(v) for v in vals[1:]], dtype=np.float64)
            if nums.size == 12:  # IMU format: append homogeneous row
                imu_to_world = np.concatenate([nums, [0, 0, 0, 1]]).reshape(4, 4)
                cam0_to_world = imu_to_world @ KITTI360_CAM_TO_IMU
            elif nums.size == 16:
                cam0_to_world = nums.reshape(4, 4)
            else:
                raise ValueError(f"invalid pose line with {nums.size + 1} numbers")
            t = cam0_to_world[:3, 3].astype(np.float32)
            q = rotation_to_quat_wxyz(cam0_to_world[:3, :3])
            poses.append((frame_idx, t, q))
    return poses


def _read_png(path: str) -> np.ndarray:
    """Minimal dependency-free PNG reader (8/16-bit gray or RGB/RGBA).

    cv2/PIL are not in the image; KITTI-360/VKITTI2 PNGs are standard
    non-interlaced files this covers.
    """
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG: {path}")
    pos = 8
    idat = b""
    width = height = bitdepth = colortype = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bitdepth, colortype, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
    raw = zlib.decompress(idat)

    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colortype]
    bpp = channels * (bitdepth // 8)
    stride = width * bpp
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    off = 0
    for r in range(height):
        ft = raw[off]
        row = np.frombuffer(raw[off + 1 : off + 1 + stride], np.uint8).copy()
        off += 1 + stride
        if ft == 1:  # Sub: per byte-lane cumulative sum mod 256
            row = row.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint64).astype(np.uint8).reshape(-1)
        elif ft == 2:  # Up
            row += prev
        elif ft == 3:  # Average
            for i in range(stride):
                left = int(row[i - bpp]) if i >= bpp else 0
                row[i] = (row[i] + ((left + int(prev[i])) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for i in range(stride):
                a = int(row[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                c = int(prev[i - bpp]) if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
        out[r] = row
        prev = row

    if bitdepth == 16:
        arr = out.reshape(height, width, channels, 2)
        img = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
    else:
        img = out.reshape(height, width, channels)
    if colortype == 3:  # palette
        img = palette[img[..., 0]]
    return img.squeeze()


@dataclasses.dataclass
class Frame:
    """One replay frame in ingest-API form."""

    depth: np.ndarray                # f32[H, W] meters
    masks: List[MaskKpts]
    cam_pos: np.ndarray              # f32[3]
    cam_quat: np.ndarray             # f32[4] (w, x, y, z)
    time: float
    index: int


class Kitti360Sequence:
    """KITTI-360 static-mode replay (the reference's SETTING 0 feeder,
    kitti360_data_reader.py:160-329): depth .npy + semantic label-id .png +
    pose txt.  No instances — one static MaskKpts per frame whose mask pixels
    hold (label_id - 1), docs/custom_files.md:43-47."""

    def __init__(
        self,
        depth_dir: str,
        semantic_dir: str,
        pose_txt: str,
        start: int = 0,
        stop: int = 1 << 30,
        repeat_first: int = 2,
        rate_hz: float = 10.0,
    ):
        self.depth_dir = depth_dir
        self.semantic_dir = semantic_dir
        self.poses = [
            p for p in read_kitti360_poses(pose_txt) if start <= p[0] <= stop
        ]
        self.repeat_first = repeat_first
        self.dt = 1.0 / rate_hz

    def __len__(self):
        return len(self.poses) + self.repeat_first

    def __iter__(self) -> Iterator[Frame]:
        # Repeat the first frame for initialization
        # (kitti360_data_reader.py:217-220).
        seq = [self.poses[0]] * self.repeat_first + self.poses if self.poses else []
        for i, (frame_idx, t, q) in enumerate(seq):
            name = str(frame_idx).zfill(10)
            depth = np.load(os.path.join(self.depth_dir, name + ".npy")).astype(
                np.float32
            )
            sem = _read_png(os.path.join(self.semantic_dir, name + ".png"))
            if sem.ndim == 3:
                sem = sem[..., 0]
            masks = [MaskKpts(track_id=65535, label="static", mask=sem.astype(np.uint8))]
            yield Frame(depth, masks, t, q, i * self.dt, frame_idx)


#: Virtual KITTI 2 class-segmentation colors -> reference label names
#: (the official VKITTI2 colormap; labels match labels.LabelRegistry.default).
VKITTI2_CLASS_COLORS = {
    (210, 0, 200): "Terrain",
    (90, 200, 255): "Sky",
    (0, 199, 0): "Tree",
    (90, 240, 0): "Vegetation",
    (140, 140, 140): "Building",
    (100, 60, 100): "Road",
    (250, 100, 255): "GuardRail",
    (255, 255, 0): "TrafficSign",
    (200, 200, 0): "TrafficLight",
    (255, 130, 0): "Pole",
    (80, 80, 80): "Misc",
    (160, 60, 60): "Truck",
    (255, 127, 80): "Car",
    (0, 139, 139): "Van",
}


class VirtualKitti2Sequence:
    """Virtual KITTI 2 official directory layout -> frames.

    ``scene_dir`` is e.g. ``Scene01/clone``.  Depth PNGs are 16-bit
    centimeters (655.35 m max); class segmentation is the color-coded PNG;
    instance segmentation PNG pixel = instance id + 1 (0 = none); extrinsics
    come from ``extrinsic.txt`` (frame cameraID r11..r33 t1..t3 world-to-cam).

    Keypoints for moving instances are synthesized from the instance mask +
    depth (bbox corners back-projected), standing in for the external
    SuperPoint tracker of docs/superpoint_mode.md.
    """

    def __init__(self, scene_dir: str, camera: int = 0, rate_hz: float = 10.0,
                 registry: Optional[LabelRegistry] = None):
        self.scene_dir = scene_dir
        self.camera = camera
        self.dt = 1.0 / rate_hz
        self.registry = registry or LabelRegistry.default()
        self.extrinsics = self._read_extrinsics(
            os.path.join(scene_dir, "extrinsic.txt")
        )

    def _read_extrinsics(self, path: str):
        out = {}
        with open(path) as f:
            header = f.readline()
            del header
            for line in f:
                vals = line.split()
                if len(vals) != 18:
                    continue
                frame, cam = int(vals[0]), int(vals[1])
                if cam != self.camera:
                    continue
                m = np.array([float(v) for v in vals[2:]], np.float64).reshape(4, 4)
                out[frame] = m  # world -> camera
        return out

    def __len__(self):
        return len(self.extrinsics)

    def _frame_paths(self, frame: int):
        cam = f"Camera_{self.camera}"
        return (
            os.path.join(self.scene_dir, "frames", "depth", cam, f"depth_{frame:05d}.png"),
            os.path.join(self.scene_dir, "frames", "classSegmentation", cam, f"classgt_{frame:05d}.png"),
            os.path.join(self.scene_dir, "frames", "instanceSegmentation", cam, f"instancegt_{frame:05d}.png"),
        )

    def __iter__(self) -> Iterator[Frame]:
        reg = self.registry
        color_to_lid = {}
        for rgb, name in VKITTI2_CLASS_COLORS.items():
            lid = reg.label_to_id.get(name, reg.label_to_id.get("Misc", 12))
            color_to_lid[rgb] = lid

        prev_kpts = {}
        for i, frame in enumerate(sorted(self.extrinsics)):
            depth_p, class_p, inst_p = self._frame_paths(frame)
            depth = _read_png(depth_p).astype(np.float32) / 100.0  # cm -> m

            cls_rgb = _read_png(class_p)
            sem = np.zeros(depth.shape, np.uint8)  # holds label_id - 1
            packed = (
                cls_rgb[..., 0].astype(np.int32) << 16
                | cls_rgb[..., 1].astype(np.int32) << 8
                | cls_rgb[..., 2].astype(np.int32)
            )
            for (r, g, b), lid in color_to_lid.items():
                sem[packed == (r << 16 | g << 8 | b)] = max(lid - 1, 0)

            masks: List[MaskKpts] = [
                MaskKpts(track_id=65535, label="static", mask=sem)
            ]

            w2c = self.extrinsics[frame]
            c2w = np.linalg.inv(w2c)
            t = c2w[:3, 3].astype(np.float32)
            q = rotation_to_quat_wxyz(c2w[:3, :3])

            if os.path.exists(inst_p):
                inst = _read_png(inst_p)
                if inst.ndim == 3:
                    inst = inst[..., 0]
                masks += self._instance_masks(inst, cls_rgb, depth, c2w, prev_kpts)

            yield Frame(depth, masks, t, q, i * self.dt, frame)

    def _instance_masks(self, inst, cls_rgb, depth, c2w, prev_kpts):
        """Instance masks + synthesized bbox-corner keypoints in world frame."""
        from .config import virtual_kitti2_config

        cfg = virtual_kitti2_config()
        out = []
        for iid in np.unique(inst):
            if iid == 0:
                continue
            m = inst == iid
            ys, xs = np.nonzero(m)
            if ys.size < 50:
                continue
            d = np.median(depth[m])
            corners_px = [
                (xs.min(), ys.min()), (xs.max(), ys.min()),
                (xs.min(), ys.max()), (xs.max(), ys.max()),
                ((xs.min() + xs.max()) // 2, (ys.min() + ys.max()) // 2),
            ]
            kpts = []
            for u, v in corners_px:
                x = (u - cfg.cx) / cfg.fx * d
                y = (v - cfg.cy) / cfg.fy * d
                p = c2w[:3, :3] @ np.array([x, y, d]) + c2w[:3, 3]
                kpts.append(p)
            kpts = np.array(kpts, np.float32)
            track = int(iid)
            prev = prev_kpts.get(track, kpts)
            prev_kpts[track] = kpts
            out.append(
                MaskKpts(
                    track_id=track,
                    label="Car",
                    mask=m.astype(np.uint8),
                    kpts_current=kpts,
                    kpts_previous=prev,
                )
            )
        return out


class NpzSequence:
    """Generic exported-tensor replay: a directory of ``frame_*.npz`` files
    (the non-ROS analog of script/tools/ros_topic_to_data.py's export).

    Each npz holds: depth f32[H,W]; static_mask u8[H,W]; cam_pos f32[3];
    cam_quat f32[4] (w,x,y,z); time f32; and optionally per-instance arrays
    inst_track i32[n], inst_label_str (json list), inst_masks u8[n,H,W],
    inst_kpts_curr f32[n,k,3], inst_kpts_prev f32[n,k,3]."""

    def __init__(self, folder: str):
        self.paths = sorted(
            os.path.join(folder, p)
            for p in os.listdir(folder)
            if re.match(r"frame_.*\.npz$", p)
        )

    def __len__(self):
        return len(self.paths)

    def __iter__(self) -> Iterator[Frame]:
        for i, path in enumerate(self.paths):
            z = np.load(path, allow_pickle=False)
            masks = [
                MaskKpts(track_id=65535, label="static", mask=z["static_mask"])
            ]
            if "inst_track" in z:
                labels = json.loads(str(z["inst_labels"])) if "inst_labels" in z else None
                for j, track in enumerate(z["inst_track"]):
                    masks.append(
                        MaskKpts(
                            track_id=int(track),
                            label=labels[j] if labels else "Car",
                            mask=z["inst_masks"][j],
                            kpts_current=z["inst_kpts_curr"][j]
                            if "inst_kpts_curr" in z
                            else None,
                            kpts_previous=z["inst_kpts_prev"][j]
                            if "inst_kpts_prev" in z
                            else None,
                        )
                    )
            yield Frame(
                depth=z["depth"].astype(np.float32),
                masks=masks,
                cam_pos=z["cam_pos"].astype(np.float32),
                cam_quat=z["cam_quat"].astype(np.float32),
                time=float(z["time"]) if "time" in z else i * 0.1,
                index=i,
            )


def save_npz_frame(folder: str, index: int, frame: Frame):
    """Write one frame in the NpzSequence format."""
    os.makedirs(folder, exist_ok=True)
    static = next(m for m in frame.masks if m.label == "static")
    inst = [m for m in frame.masks if m.label != "static"]
    arrays = dict(
        depth=frame.depth.astype(np.float32),
        static_mask=static.mask.astype(np.uint8),
        cam_pos=np.asarray(frame.cam_pos, np.float32),
        cam_quat=np.asarray(frame.cam_quat, np.float32),
        time=np.float32(frame.time),
    )
    if inst:
        arrays["inst_track"] = np.array([m.track_id for m in inst], np.int32)
        arrays["inst_labels"] = json.dumps([m.label for m in inst])
        arrays["inst_masks"] = np.stack([m.mask.astype(np.uint8) for m in inst])
        kc = [np.asarray(m.kpts_current, np.float32) if m.kpts_current is not None
              else np.zeros((0, 3), np.float32) for m in inst]
        n = max(k.shape[0] for k in kc)
        arrays["inst_kpts_curr"] = np.stack(
            [np.pad(k, ((0, n - k.shape[0]), (0, 0))) for k in kc]
        )
        kp = [np.asarray(m.kpts_previous, np.float32) if m.kpts_previous is not None
              else np.zeros((0, 3), np.float32) for m in inst]
        arrays["inst_kpts_prev"] = np.stack(
            [np.pad(k, ((0, n - k.shape[0]), (0, 0))) for k in kp]
        )
    np.savez_compressed(os.path.join(folder, f"frame_{index:06d}.npz"), **arrays)
