"""Label/instance registry (a copy of ``semantic_dsp_map_tpu/labels.py``,
which cannot be imported without JAX).

Replaces the reference's mutable global label maps
(include/utils/data_base.h:108-232) and the CSV loader that rewrites them
(include/utils/object_info_handler.h:28-91) with an immutable registry object.

Semantics preserved:
  - static classes occupy reserved instance ids counting down from 65535
    (data_base.h:181-194);
  - ``max_movable_instance_id`` = (smallest static instance id) - 1
    (object_info_handler.h:61-69, default 65523 at data_base.h:196);
  - CSV schema ``label_id,label,instance_id(-1 means movable),b,g,r``
    (docs/custom_files.md:1-16, cfg/object_info*.csv).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

#: Sentinel instance id for "no/unknown instance" (== Background's fixed id).
BACKGROUND_INSTANCE_ID = 65535


@dataclasses.dataclass(frozen=True)
class LabelRegistry:
    label_to_id: Dict[str, int]
    id_to_label: Dict[int, str]
    movable_label_ids: frozenset
    static_label_to_instance: Dict[str, int]
    instance_to_label: Dict[int, str]
    max_movable_instance_id: int
    label_color_bgr: Dict[int, Tuple[int, int, int]]

    # ------------------------------------------------------------------
    @staticmethod
    def default() -> "LabelRegistry":
        """The 15-class Virtual KITTI palette baked into data_base.h:108-232."""
        label_to_id = {
            "Background": 0, "Terrain": 2, "Sky": 3, "Tree": 4,
            "Vegetation": 5, "Building": 6, "Road": 7, "GuardRail": 8,
            "TrafficSign": 9, "TrafficLight": 10, "Pole": 11, "Misc": 12,
            "Truck": 13, "Car": 14, "Person": 15,
        }
        static_to_instance = {
            "Background": 65535, "Terrain": 65534, "Sky": 65533, "Tree": 65532,
            "Vegetation": 65531, "Building": 65530, "Road": 65529,
            "GuardRail": 65528, "TrafficSign": 65527, "TrafficLight": 65526,
            "Pole": 65525, "Misc": 65524,
        }
        colors = {
            0: (0, 0, 0), 2: (200, 0, 210), 3: (255, 200, 90), 4: (0, 199, 0),
            5: (0, 240, 90), 6: (140, 140, 140), 7: (100, 60, 100),
            8: (255, 100, 250), 9: (0, 255, 255), 10: (0, 200, 200),
            11: (0, 130, 255), 12: (80, 80, 80), 13: (60, 60, 160),
            14: (80, 127, 255), 15: (139, 139, 0),
        }
        return LabelRegistry(
            label_to_id=label_to_id,
            id_to_label={v: k for k, v in label_to_id.items()},
            movable_label_ids=frozenset({13, 14, 15}),
            static_label_to_instance=static_to_instance,
            instance_to_label={v: k for k, v in static_to_instance.items()},
            max_movable_instance_id=65523,
            label_color_bgr=colors,
        )

    # ------------------------------------------------------------------
    @staticmethod
    def from_csv(path: str) -> "LabelRegistry":
        """Load a reference-format object-info CSV (object_info_handler.h:28-91).

        Rows with ``instance_id > 0`` are static classes with a fixed instance
        id; rows with ``instance_id == -1`` are movable classes.
        """
        label_to_id: Dict[str, int] = {}
        movable: set = set()
        static_to_instance: Dict[str, int] = {}
        colors: Dict[int, Tuple[int, int, int]] = {}
        max_movable = 65535

        with open(path) as f:
            lines = f.read().strip().splitlines()
        for line in lines[1:]:  # skip header
            parts = [p.strip() for p in line.split(",")]
            if len(parts) < 6:
                continue
            label_id = int(parts[0])
            label = parts[1]
            instance_id = int(parts[2])
            b, g, r = int(parts[3]), int(parts[4]), int(parts[5])

            label_to_id[label] = label_id
            colors[label_id] = (b, g, r)
            if instance_id > 0:
                static_to_instance[label] = instance_id
                max_movable = min(max_movable, instance_id - 1)
            else:
                movable.add(label_id)

        return LabelRegistry(
            label_to_id=label_to_id,
            id_to_label={v: k for k, v in label_to_id.items()},
            movable_label_ids=frozenset(movable),
            static_label_to_instance=static_to_instance,
            instance_to_label={v: k for k, v in static_to_instance.items()},
            max_movable_instance_id=max_movable,
            label_color_bgr=colors,
        )

    # ------------------------------------------------------------------
    # Dense lookup tables consumed by the array kernels
    # ------------------------------------------------------------------

    def static_pixel_value_to_instance_table(self) -> np.ndarray:
        """Table mapping (static-mask pixel value + 1 interpreted as label id)
        -> fixed static instance id, used to build the track-id raster
        (pointcloud_tools.h:133-140).  Unknown pixel values map to Background
        (65535)."""
        table = np.full(256, BACKGROUND_INSTANCE_ID, dtype=np.int32)
        for label, inst in self.static_label_to_instance.items():
            lid = self.label_to_id.get(label)
            if lid is not None and 0 <= lid < 256:
                table[lid] = inst
        return table

    def instance_to_label_id_table(self) -> np.ndarray:
        """Table mapping static instance ids (offsets from max id 65535) back
        to label ids (pointcloud_tools.h:277-279).  Indexed by
        ``65535 - instance_id`` for instance ids above max_movable; size 4096
        is far beyond any realistic static class count."""
        table = np.zeros(4096, dtype=np.int32)
        for inst, label in self.instance_to_label.items():
            lid = self.label_to_id.get(label, 0)
            off = 65535 - inst
            if 0 <= off < table.size:
                table[off] = lid
        return table

    def label_color_table(self) -> np.ndarray:
        """Dense [256,3] BGR color table (data_base.h:216-232)."""
        table = np.zeros((256, 3), dtype=np.uint8)
        for lid, bgr in self.label_color_bgr.items():
            if 0 <= lid < 256:
                table[lid] = bgr
        return table
