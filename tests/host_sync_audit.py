"""What the card's capture refuses, found on the CPU: a dispatch-mode audit of
the ops that read the device to the host.

This module imports no JAX: the sharded step's ranks (tests/torch_shard_worker.py)
use it as well as tests/test_torch_graph.py.
"""

import collections
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_A = torch.ops.aten
#: Ops that, on a CUDA tensor, read the device to the host, size an output by
#: the data, or copy from host memory (``torch.tensor`` of Python values is
#: ``lift_fresh``): each synchronizes, and a capture refuses it.
_HOST_SYNC = {
    _A.lift_fresh.default, _A._local_scalar_dense.default, _A.nonzero.default,
    _A.masked_select.default, _A.bincount.default, _A.repeat_interleave.Tensor,
    _A.is_nonzero.default, _A.equal.default, _A._unique2.default,
    _A.unique_consecutive.default, _A.unique_dim.default, _A._linalg_svd.default,
    _A._linalg_check_errors.default,
}
_INDEXING = {_A.index.Tensor, _A.index_put_.default, _A.index_put.default,
             _A._index_put_impl_.default}


class HostSyncAudit(TorchDispatchMode):
    """Counts, by op and the port's source line, the ops of ``_HOST_SYNC``
    and indexing by a boolean mask (a ``nonzero`` on the card); ``collectives``
    counts the ``torch.distributed`` ops (namespace ``c10d``) that ran inside."""

    def __init__(self):
        super().__init__()
        self.hits = collections.Counter()
        self.collectives = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        hit = func in _HOST_SYNC or (func in _INDEXING and any(
            i is not None and i.dtype in (torch.bool, torch.uint8) for i in args[1]))
        if hit:
            frames = [f for f in traceback.extract_stack()
                      if "semantic_dsp_map_tpu_torch" in f.filename]
            where = f"{frames[-1].filename.rsplit('/', 1)[-1]}:{frames[-1].lineno}"
            self.hits[(str(func), where)] += 1
        if func.namespace == "c10d":
            self.collectives[str(func)] += 1
        return func(*args, **(kwargs or {}))
