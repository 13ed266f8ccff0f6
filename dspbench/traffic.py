"""The benchmark's one scene generator.  A traffic mix is a JSON file of
parameters in ``dspbench/traffic/``; this module turns it, a camera and a
seed into a ring of frames.

A frame is what a driving stack hands the map: a depth image at the
sensor's size, panoptic masks (one static background mask, whose pixels
hold label id - 1, and one mask a tracked mover with its keypoints in the
camera frame, current and previous), the camera pose and the time.  The
ring holds ``ring`` images, made at set-up; frame ``i`` shows image
``i % ring`` at the pose of index ``i``, so set-up does not grow with the
run.  Every mover's motion repeats with the ring where its ``speed`` times
``ring`` is a whole number of crossings.

The seed draws the depth noise (and nothing else): every seed gives the same
sizes, masks, movers and poses, so runs with different seeds do the same
work.  The scenes follow the port's ``benchmarks/scenes.py``
(``synth_vkitti2_frame``, ``synth_zed2_frame``, ``synth_hostile_frame``),
with the seed threaded into the noise.

Parameters (keys of the file):

- ``ring``: images in the ring; ``frame_dt``: seconds between frames;
- ``background_depth`` (m), ``ground_height`` (m under the camera, below
  the principal row), ``depth_noise`` (m, one standard deviation);
- ``labels``: ``{"upper": id, "ground": id, "split": "horizon" | "half"}``:
  the static mask's label ids above / below the principal row, or the top
  and bottom half of the image;
- ``wall``: null, or ``{"depth", "noise", "rows": [top, bottom], "width",
  "start", "speed", "wrap"}`` (fractions of the image): a near wall whose
  left edge moves ``speed`` of the width a frame, modulo ``wrap`` of it;
- ``movers``: a list of ``{"track", "label", "depth", "top", "height",
  "width", "start", "speed", "wrap_inside", "kpts", "kpts_y_from_top",
  "prev_dx"}``: a box of pixels at ``depth``, its top row and size as
  fractions of the image, its left edge at ``start + speed * i`` of the
  width, modulo the width (less its own width where ``wrap_inside``);
  ``kpts`` are offsets (m) from (its left edge's x at its depth, 0 or its
  top's y, its depth); the previous keypoints lie ``prev_dx`` m to the left,
  or, where ``prev_dx`` is ``"speed"``, one frame's motion to the left;
- ``ego``: ``{"velocity": [x, y, z] m a frame, "yaw": radians a frame}``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"

#: The static background mask's track id (docs/custom_files.md of the
#: reference: label == "static", track 65535).
STATIC_TRACK = 65535


class Camera(NamedTuple):
    """The sensor: image size and intrinsics (before any BOOST resize)."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def of(cls, cfg: dict) -> "Camera":
        """From a configuration's ``MapConfig`` fields."""
        return cls(cfg["image_width"], cfg["image_height"], cfg["camera_fx"], cfg["camera_fy"],
                   cfg["camera_cx"], cfg["camera_cy"])


class Frame(NamedTuple):
    depth: np.ndarray   # f32[H, W]
    masks: list         # dicts with MaskKpts' fields
    cam_pos: np.ndarray   # f32[3]
    cam_quat: np.ndarray  # f32[4] (w, x, y, z)
    time: float


def load(name: str, folder: Path = TRAFFIC_DIR) -> dict:
    """The traffic mix ``name`` (``<folder>/<name>.json``)."""
    with open(folder / f"{name}.json") as f:
        return json.load(f)


def noise_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of image ``index``'s noise under ``seed``."""
    if seed < 0:
        raise ValueError(f"seed {seed}: a seed is a whole number from 0 up")
    return np.random.default_rng([seed, index])


def image(mix: dict, cam: Camera, seed: int, index: int):
    """Image ``index`` of the ring: (depth f32[H, W], masks)."""
    H, W = cam.height, cam.width
    rng = noise_rng(seed, index)
    v = np.arange(H, dtype=np.float32)[:, None]
    depth = np.full((H, W), mix["background_depth"], np.float32)
    ground = np.float32(cam.fy * mix["ground_height"]) / np.maximum(v - np.float32(cam.cy),
                                                                   np.float32(1e-3))
    depth = np.minimum(depth, np.where(v > cam.cy, ground, depth))
    depth += rng.standard_normal((H, W), dtype=np.float32) * np.float32(mix["depth_noise"])

    lab = mix["labels"]
    if lab["split"] == "horizon":
        static = np.where(v > cam.cy, lab["ground"], lab["upper"]).astype(np.uint8)
        static = static * np.ones((1, W), np.uint8)
    elif lab["split"] == "half":
        static = np.full((H, W), lab["ground"], np.uint8)
        static[: H // 2] = lab["upper"]
    else:
        raise ValueError(f"labels.split: {lab['split']!r} (horizon or half)")

    wall = mix.get("wall")
    if wall:
        top, bottom = int(wall["rows"][0] * H), int(wall["rows"][1] * H)
        ww = int(wall["width"] * W)
        w0 = int((wall["start"] + wall["speed"] * index) * W) % int(wall["wrap"] * W)
        if wall["wrap"] + wall["width"] > 1:
            raise ValueError("wall: wrap + width must stay inside the image")
        patch = rng.standard_normal((bottom - top, ww), dtype=np.float32)
        depth[top:bottom, w0 : w0 + ww] = np.float32(wall["depth"]) + patch * np.float32(wall["noise"])

    masks = [dict(track_id=STATIC_TRACK, label="static", mask=static)]
    for m in mix["movers"]:
        mw, mh = int(m["width"] * W), int(m["height"] * H)
        top = int(m["top"] * H)
        span = W - mw if m.get("wrap_inside") else W
        x0 = int((m["start"] + m["speed"] * index) * W) % span
        box = np.zeros((H, W), np.uint8)
        box[top : top + mh, x0 : x0 + mw] = 1
        z = float(m["depth"])
        depth[box > 0] = z
        xl = (x0 - cam.cx) / cam.fx * z
        y0 = (top - cam.cy) / cam.fy * z if m.get("kpts_y_from_top") else 0.0
        kc = (np.asarray(m["kpts"], np.float64) + np.array([xl, y0, z])).astype(np.float32)
        dx = m["speed"] * W / cam.fx * z if m["prev_dx"] == "speed" else float(m["prev_dx"])
        kp = kc - np.array([dx, 0.0, 0.0], np.float32)
        masks.append(dict(track_id=int(m["track"]), label=m["label"], mask=box,
                          kpts_current=kc, kpts_previous=kp))
    return depth, masks


def pose(mix: dict, index: int):
    """(cam_pos f32[3], cam_quat f32[4], time) of frame ``index``."""
    ego = mix["ego"]
    pos = (np.asarray(ego["velocity"], np.float64) * index).astype(np.float32)
    yaw = ego["yaw"] * index
    quat = np.array([math.cos(yaw / 2), 0.0, math.sin(yaw / 2), 0.0], np.float32)
    return pos, quat, float(index * mix["frame_dt"])


class Ring:
    """The images of a mix under one seed, made at once; ``frame(i)`` is
    frame ``i`` of the stream."""

    def __init__(self, mix: dict, cam: Camera, seed: int):
        self.mix = mix
        self.images = [image(mix, cam, seed, k) for k in range(mix["ring"])]

    def __len__(self) -> int:
        return len(self.images)

    def frame(self, i: int) -> Frame:
        depth, masks = self.images[i % len(self.images)]
        return Frame(depth, masks, *pose(self.mix, i))
