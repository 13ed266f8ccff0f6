"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Build.  The sources have a plain C interface and are compiled by ``nvcc``
(one process per source, in parallel) and linked into one shared library,
loaded with ctypes.  The build runs at first use and is keyed on a hash of
the sources and flags, under ``build/kernels/`` at the repository root (a
cache, listed in .gitignore).  Nothing here runs at import time: the CPU
tests import every module on a machine without nvcc.

Launch.  A wrapper (``ops/*_cuda.py``) reaches the card in four steps, each
paid once a launch and no more: ``pointers`` checks its tensors of one
dtype and shape in one pass (device, dtype, shape, contiguity) and returns
their device pointers; ``torch.empty`` allocates the outputs;
``stream_ptr`` reads the raw handle of PyTorch's current stream (the
accessor PyTorch's own Triton launcher uses: no ``torch.cuda.Stream`` is
built, and under CUDA-graph capture it is the capture stream); and the C
entry point is called through ``entry``, whose attributes are the ctypes
function objects of the loaded library, resolved once with their argtypes
(pointers, ints and Python floats are converted by those).  The C function
launches with ``cuLaunchKernel`` on a ``CUfunction`` looked up once
(``csrc/launch.cuh``) and returns its error code; the wrapper
raises ``error(err, name)`` if that is not 0.  Each wrapper is registered
with ``counted`` and adds one to its ``launches`` a launch.
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
SOURCES = ("phd.cu", "render.cu", "observe.cu", "probes.cu", "graph.cu", "birth.cu",
           "templates.cu")

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: Precise math on purpose: pass B's "rightly updated" flag is compared bit
#: for bit with the plain version, and a contracted FMA or a fast exp can
#: flip it at an ulp boundary.
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

#: The kernels launch with cuLaunchKernel of libcuda (csrc/launch.cuh).
LINK_FLAGS = ("-lcuda",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: argtypes of every C entry point (each returns 0 or a CUDA error code).
SIGNATURES = {
    # 10 inputs, ck; S, H, W, R; coef3, id_p; independent; stream
    "dsp_pass_a": [_P] * 11 + [_I] * 4 + [_F, _F, _I, _P],
    # 12 inputs, acc, right; S, H, W, R; coef3, id_p, right threshold;
    # independent; stream
    "dsp_pass_b": [_P] * 14 + [_I] * 4 + [_F, _F, _F, _I, _P],
    # S, H, W, R: 1 where the pass runs its wide instance (after dsp_live_planes)
    "dsp_pass_a_is_wide": [_I] * 4,
    "dsp_pass_b_is_wide": [_I] * 4,
    # the table's deciding plane, the live words, acc, right (pass B only);
    # S, H, W, tracks; stream
    "dsp_live_planes": [_P] * 4 + [_I] * 4 + [_P],
    # the wide instances: dsp_pass_a's / dsp_pass_b's arguments with the
    # live words after the inputs
    "dsp_pass_a_wide": [_P] * 12 + [_I] * 4 + [_F, _F, _I, _P],
    "dsp_pass_b_wide": [_P] * 15 + [_I] * 4 + [_F, _F, _F, _I, _P],
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
    # csrc/birth.cu: the store's nine fields (in place), vox_axis, ids, six
    # staged buffers, the accepted count; A, bv, K, nb, resample, trigger;
    # stream
    "dsp_merge_blocks": [_P] * 18 + [ctypes.c_longlong, _I, _I, ctypes.c_longlong, _I, _I, _P],
    # the same, then the per-lane acceptance (u8 [A, bv, K]) after the count
    "dsp_merge_blocks_accepted": [_P] * 19 + [ctypes.c_longlong, _I, _I, ctypes.c_longlong, _I,
                                              _I, _P],
    # csrc/templates.cu: the cloud's track, validity, positions; the object
    # table's five flags, track ids and labels; the scratch, the gate;
    # pixels, rows, the Car label; stream
    "dsp_template_gate": [_P] * 12 + [_I] * 3 + [_P],
    # the store's track and status (in place), the slots' good flags and track
    # ids; slots, store slots; stream
    "dsp_delete_matched": [_P] * 4 + [_I, ctypes.c_longlong, _P],
    # csrc/graph.cu: a conditional IF node under capture (step_graph.slot_cond)
    "dsp_if_node_prepare": [],
    # capture stream, the device flag (bool), the side stream of the body
    "dsp_if_node_begin": [_P] * 3,
    # the side stream of the body
    "dsp_if_node_end": [_P],
    # csrc/graph.cu: the frame tracer's stamp (timing.stamp_cuda): cursor,
    # stamp ring, counter ring; capacity, the two rings' widths, column,
    # first, the counts' first column and number; their pointers (a host
    # array of device pointers); stream
    "dsp_stamp": [_P] * 3 + [_I] * 7 + [_P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _source_hash(csrc: Path) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *LINK_FLAGS)).encode())
    for path in sorted(csrc.glob("*.cu*")):  # the sources and the headers they include
        h.update(path.name.encode() + path.read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC) -> tuple[Path, float, str]:
    """Compile the kernels if the cached library is missing.  Returns
    (library path, seconds spent building, nvcc's output).  ``csrc`` is the
    package's own sources; a measurement that holds them against another
    version of the same sources names that version's directory, which may
    lack a source that version did not have yet (``graph.cu`` before the
    template slots were captured, ``birth.cu`` before birth's merge was a
    kernel)."""
    sources = [src for src in SOURCES if csrc == CSRC or (csrc / src).exists()]
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
        objects = [str(Path(tmp) / (Path(s).stem + ".o")) for s in sources]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(csrc / src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objects)
        ]
        output = "".join(proc.communicate()[0] for proc in procs)
        failed = [src for src, proc in zip(sources, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{output}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp_lib), *objects, *LINK_FLAGS],
                              capture_output=True, text=True)
        output += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{output}")
        log.write_text(output)
        os.replace(tmp_lib, lib)
    return lib, time.perf_counter() - t0, output


def load(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its entry points.  Loaded as
    a ``PyDLL``: a call keeps the interpreter lock, which saves releasing and
    taking it again on every launch (each entry point only enqueues work)."""
    lib = ctypes.PyDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if not hasattr(lib, name):
            continue  # another version's build, from before this entry point
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


class _EntryPoints:
    """The C entry points the wrappers launch, one attribute each (the names
    of ``SIGNATURES`` and ``dsp_error_string``): the ctypes function objects
    of one loaded library.  The first lookup builds and binds the package's
    library; ``bind`` puts another build's in place."""

    def __getattr__(self, name: str):
        if name not in SIGNATURES and name != "dsp_error_string":
            raise AttributeError(name)
        bind(library())
        return self.__dict__[name]


entry = _EntryPoints()


def bind(lib: ctypes.CDLL) -> None:
    """Make ``lib``'s entry points the ones ``entry`` holds (those it has:
    another version's build may lack the newest)."""
    names = (*SIGNATURES, "dsp_error_string")
    entry.__dict__.update({name: getattr(lib, name) for name in names if hasattr(lib, name)})


def error(err: int, name: str) -> RuntimeError:
    """The error to raise when the C entry point ``name`` returned ``err``."""
    msg = entry.dsp_error_string(err).decode()
    return RuntimeError(f"{name}: CUDA error {err} ({msg})")


#: Every kernel wrapper whose module has been imported (``counted``).
WRAPPERS: list = []


def counted(fn):
    """Register the kernel wrapper ``fn`` in ``WRAPPERS`` with a launch
    count of 0; the wrapper adds one to ``fn.launches`` where it launches
    its kernel."""
    fn.launches = 0
    WRAPPERS.append(fn)
    return fn


def _refuse(t: torch.Tensor, name: str, index: int, dtype: torch.dtype, shape) -> None:
    """Raise the ValueError that names what is wrong with argument ``name``."""
    if t.get_device() != index:
        if index >= 0 and not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        raise ValueError(f"{name}: expected a tensor on device {index}, got {t.device}")
    if t.dtype is not dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def pointers(index: int, dtype: torch.dtype, shape, tensors, names) -> list:
    """Data pointers of ``tensors``, after one pass that checks each is a
    contiguous ``dtype`` tensor of ``shape`` (any shape if None) on device
    ``index`` (``Tensor.get_device()``'s number: a CUDA device, or -1 for
    the CPU, which no kernel takes).  A tensor that is not raises ValueError
    naming its argument: ``names`` holds them in the same order."""
    ptrs = []
    for t in tensors:
        if (t.dtype is not dtype or t.get_device() != index or not t.is_contiguous()
                or (shape is not None and t.shape != shape)):
            for u, name in zip(tensors, names):
                _refuse(u, name, index, dtype, shape)
        ptrs.append(t.data_ptr())
    return ptrs


#: ``stream_ptr(index)``: the raw ``cudaStream_t`` of PyTorch's current
#: stream on CUDA device ``index`` (a device index, not a ``torch.device``).
#: It is PyTorch's own accessor, which a CPU-only build lacks.
stream_ptr = getattr(torch._C, "_cuda_getCurrentRawStream", None)
