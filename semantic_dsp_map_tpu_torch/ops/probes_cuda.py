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
from .probes import check_gather_args, gather_plain, scale2_plain


def gather_cuda(depth: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """f32[N]; see ops.probes.gather_plain."""
    if not depth.is_cuda:
        return gather_plain(depth, rc)
    check_gather_args(depth, rc)
    n = rc.shape[0]
    ptrs = [
        cuda_lib.require(depth, "depth", torch.float32),
        cuda_lib.require(rc, "rc", torch.int32, (n,)),
    ]
    out = torch.empty(n, dtype=torch.float32, device=depth.device)
    err = cuda_lib.library().dsp_gather(
        *ptrs, out.data_ptr(), n, cuda_lib.stream_ptr(depth.device))
    cuda_lib.check(err, "dsp_gather")
    gather_cuda.launches += 1
    return out


def scale2_cuda(x: torch.Tensor) -> torch.Tensor:
    """f32 of x's shape; see ops.probes.scale2_plain."""
    if not x.is_cuda:
        return scale2_plain(x)
    ptr = cuda_lib.require(x, "x", torch.float32)
    out = torch.empty_like(x)
    err = cuda_lib.library().dsp_scale2(
        ptr, out.data_ptr(), x.numel(), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "dsp_scale2")
    scale2_cuda.launches += 1
    return out


gather_cuda.launches = 0
scale2_cuda.launches = 0
