"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources have a plain C interface and are compiled by ``nvcc`` (one
process per source, in parallel) and linked into one shared library, loaded
with ctypes.  The build runs at first use and is
keyed on a hash of the sources and flags, under ``build/kernels/`` at the
repository root (a cache, listed in .gitignore).  Nothing here runs at
import time: the CPU tests import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("phd.cu", "render.cu", "observe.cu", "probes.cu")

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: Precise math on purpose: pass B's "rightly updated" flag is compared bit
#: for bit with the plain version, and a contracted FMA or a fast exp can
#: flip it at an ulp boundary.
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: argtypes of every C entry point (each returns cudaGetLastError()).
SIGNATURES = {
    # 10 inputs, ck; S, H, W, R; coef3, id_p; independent; stream
    "dsp_pass_a": [_P] * 11 + [_I] * 4 + [_F, _F, _I, _P],
    # 12 inputs, acc, right; S, H, W, R; coef3, id_p, right threshold;
    # independent; stream
    "dsp_pass_b": [_P] * 14 + [_I] * 4 + [_F, _F, _F, _I, _P],
    # 7 inputs (weight and status updated in place), 4 outputs; V, K;
    # threshold, newborn weight; stream
    "dsp_render": [_P] * 11 + [ctypes.c_longlong, _I, _F, _F, _P],
    # 7 inputs, 2 outputs; V, K; fx, fy, cx, cy; h, w; dmin, dmax; stream
    "dsp_front_candidates": [_P] * 9 + [ctypes.c_longlong, _I] + [_F] * 4 + [_I, _I, _F, _F, _P],
    # 4 inputs, 1 output; V, K, max_movable; stream
    "dsp_movable_voxels": [_P] * 5 + [ctypes.c_longlong, _I, _I, _P],
    # table, index, output; number of lookups; stream
    "dsp_gather": [_P] * 3 + [ctypes.c_longlong, _P],
    # input, output; number of elements; stream
    "dsp_scale2": [_P] * 2 + [ctypes.c_longlong, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _source_hash(csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC) -> tuple[Path, float, str]:
    """Compile the kernels if the cached library is missing.  Returns
    (library path, seconds spent building, nvcc's output).  ``csrc`` is the
    package's own sources; a measurement that holds them against another
    version of the same sources names that version's directory."""
    out_dir = BUILD_ROOT / _source_hash(csrc)
    lib = out_dir / "libdsp_kernels.so"
    log = out_dir / "nvcc.log"
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        # One nvcc per source, all started together, then one link.
        nvcc = _nvcc()
        objects = [str(Path(tmp) / (Path(s).stem + ".o")) for s in SOURCES]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(csrc / src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objects)
        ]
        output = "".join(proc.communicate()[0] for proc in procs)
        failed = [src for src, proc in zip(SOURCES, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{output}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp_lib), *objects],
                              capture_output=True, text=True)
        output += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{output}")
        log.write_text(output)
        os.replace(tmp_lib, lib)
    return lib, time.perf_counter() - t0, output


def load(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dsp_error_string.argtypes = [_I]
    lib.dsp_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The package's kernel library (built on first call)."""
    return load(build()[0])


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().dsp_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> int:
    """Validate a kernel argument and return its device pointer."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
