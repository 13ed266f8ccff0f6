"""Wrappers of the hand-written CUDA probe kernels (csrc/probes.cu).

``gather_cuda`` replaces ``pallas_gather`` (the TPU kernel ``gather_kernel``
of benchmarks/prim_bench7.py) and ``scale2_cuda`` replaces the TPU kernel
``k_`` of benchmarks/prim_bench1.py.  On CUDA tensors they launch the
kernel; on CPU tensors they run the plain versions of ops/probes.py, their
oracles, which take the same arguments.  Bound and design: see the note at
the top of csrc/probes.cu.

``gather_cuda.launches`` / ``scale2_cuda.launches`` count kernel launches.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .probes import gather_plain, scale2_plain


@cuda_lib.counted
def gather_cuda(depth: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """f32[N]; see ops.probes.gather_plain.  An empty index launches
    nothing and gives an empty tensor, as the plain version does."""
    index = depth.get_device()
    if index < 0:  # the CPU: the plain version
        return gather_plain(depth, rc)
    n = rc.numel()
    ptrs = cuda_lib.pointers(index, torch.float32, None, (depth,), ("depth",))
    ptrs += cuda_lib.pointers(index, torch.int32, (n,), (rc,), ("rc",))
    out = torch.empty(n, dtype=torch.float32, device=depth.device)
    if n == 0:
        return out
    err = cuda_lib.entry.dsp_gather(*ptrs, out.data_ptr(), n, cuda_lib.stream_ptr(index))
    if err:
        raise cuda_lib.error(err, "dsp_gather")
    gather_cuda.launches += 1
    return out


@cuda_lib.counted
def scale2_cuda(x: torch.Tensor) -> torch.Tensor:
    """f32 of x's shape; see ops.probes.scale2_plain.  An empty tensor
    launches nothing."""
    index = x.get_device()
    if index < 0:  # the CPU: the plain version
        return scale2_plain(x)
    (ptr,) = cuda_lib.pointers(index, torch.float32, None, (x,), ("x",))
    out = torch.empty_like(x)
    n = out.numel()
    if n == 0:
        return out
    err = cuda_lib.entry.dsp_scale2(ptr, out.data_ptr(), n, cuda_lib.stream_ptr(index))
    if err:
        raise cuda_lib.error(err, "dsp_scale2")
    scale2_cuda.launches += 1
    return out
