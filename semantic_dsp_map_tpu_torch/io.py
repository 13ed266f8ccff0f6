"""Point-cloud file IO: PCD read/write and PLY write (a copy of
``semantic_dsp_map_tpu/io.py``, which cannot be imported without JAX; the
writers' bytes are held equal by tests/test_torch_io.py).

The reference loads CAD templates from ``.pcd`` files via PCL
(pointcloud_tools.h:382-420 readExistingPointCloudTemplates) and its companion
global-mapping repo writes ``.ply`` clouds (docs/static_mode.md:48-52).  This
module provides dependency-free numpy equivalents so the framework can consume
the reference's template files unchanged and emit clouds any viewer can open.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# PCD
# ---------------------------------------------------------------------------

_PCD_TYPE_TO_DTYPE = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
}


def read_pcd(path: str) -> np.ndarray:
    """Read a PCD v0.7 file (ascii, binary, or binary_compressed is NOT
    supported) and return its xyz points as f32[N, 3].

    Mirrors what pcl::io::loadPCDFile<pcl::PointXYZ> extracts
    (pointcloud_tools.h:397-401): only the x/y/z fields are kept.
    """
    with open(path, "rb") as f:
        header: Dict[str, List[str]] = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, *vals = line.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n_points = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()

        dtype_fields = []
        for name, size, typ, count in zip(fields, sizes, types, counts):
            base = _PCD_TYPE_TO_DTYPE[(typ, size)]
            if count == 1:
                dtype_fields.append((name, base))
            else:
                dtype_fields.append((name, base, (count,)))
        dtype = np.dtype(dtype_fields)

        if mode == "ascii":
            body = f.read().decode("ascii", "ignore")
            rows = [r.split() for r in body.strip().splitlines() if r.strip()]
            arr = np.zeros(n_points, dtype=dtype)
            flat_names = []
            for name, size, typ, count in zip(fields, sizes, types, counts):
                flat_names.extend([(name, i) for i in range(count)])
            for i, row in enumerate(rows[:n_points]):
                for (name, sub), val in zip(flat_names, row):
                    if dtype[name].shape:
                        arr[name][i][sub] = float(val)
                    else:
                        arr[name][i] = float(val)
        elif mode == "binary":
            arr = np.frombuffer(f.read(dtype.itemsize * n_points), dtype=dtype, count=n_points)
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")

    xyz = np.stack(
        [arr["x"].astype(np.float32), arr["y"].astype(np.float32), arr["z"].astype(np.float32)],
        axis=1,
    )
    # PCL drops NaN points on load for PointXYZ consumers.
    return xyz[np.isfinite(xyz).all(axis=1)]


def write_pcd(path: str, xyz: np.ndarray, rgb: Optional[np.ndarray] = None, binary: bool = True):
    """Write xyz (f32[N,3]) and optional rgb (u8[N,3]) as a PCD v0.7 file."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = xyz.shape[0]
    if rgb is not None:
        packed = (
            rgb[:, 0].astype(np.uint32) << 16
            | rgb[:, 1].astype(np.uint32) << 8
            | rgb[:, 2].astype(np.uint32)
        ).view(np.float32)
        fields = "FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1"
        data = np.empty((n, 4), np.float32)
        data[:, :3] = xyz
        data[:, 3] = packed
    else:
        fields = "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1"
        data = xyz

    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        f"{fields}\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def find_files_with_extension(folder: str, extension: str) -> List[str]:
    """findFilesWithExtension (basic_algorithms.h:323-355): recursive search,
    sorted for determinism."""
    out = []
    for root, _dirs, files in os.walk(folder):
        for name in files:
            if name.endswith(extension):
                out.append(os.path.join(root, name))
    return sorted(out)


def read_template_folder(folder: str) -> Dict[int, List[np.ndarray]]:
    """readExistingPointCloudTemplates (pointcloud_tools.h:382-420): load all
    ``.pcd`` files under ``folder``; each template's label id is the name of
    its immediate parent directory."""
    templates: Dict[int, List[np.ndarray]] = {}
    for path in find_files_with_extension(folder, ".pcd"):
        label_id = int(os.path.basename(os.path.dirname(path)))
        templates.setdefault(label_id, []).append(read_pcd(path))
    return templates


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

def write_ply(path: str, xyz: np.ndarray, rgb: Optional[np.ndarray] = None):
    """Write a binary little-endian PLY point cloud (the output format of the
    reference's companion global-mapping tool, docs/static_mode.md:48-52)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = xyz.shape[0]
    props = "property float x\nproperty float y\nproperty float z\n"
    if rgb is not None:
        rgb = np.ascontiguousarray(rgb, np.uint8)
        props += "property uchar red\nproperty uchar green\nproperty uchar blue\n"
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n{props}end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if rgb is not None:
            rec = np.dtype([("xyz", np.float32, (3,)), ("rgb", np.uint8, (3,))])
            buf = np.empty(n, rec)
            buf["xyz"] = xyz
            buf["rgb"] = rgb
            f.write(buf.tobytes())
        else:
            f.write(xyz.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a PLY point cloud (ascii or binary_little_endian) -> (xyz, rgb?)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        n = 0
        props: List[Tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n = int(cnt)
            elif line.startswith("property") and in_vertex:
                _, typ, name = line.split()
                props.append((typ, name))
            elif line == "end_header":
                break

        type_map = {
            "float": np.float32, "float32": np.float32, "double": np.float64,
            "uchar": np.uint8, "uint8": np.uint8, "int": np.int32,
            "uint": np.uint32, "short": np.int16, "ushort": np.uint16,
            "char": np.int8,
        }
        dtype = np.dtype([(name, type_map[typ]) for typ, name in props])
        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(n)]
            arr = np.zeros(n, dtype)
            for i, row in enumerate(rows):
                for (typ, name), val in zip(props, row):
                    arr[name][i] = float(val)
        else:
            arr = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)

    xyz = np.stack([arr["x"], arr["y"], arr["z"]], 1).astype(np.float32)
    rgb = None
    if "red" in dtype.names:
        rgb = np.stack([arr["red"], arr["green"], arr["blue"]], 1).astype(np.uint8)
    return xyz, rgb
