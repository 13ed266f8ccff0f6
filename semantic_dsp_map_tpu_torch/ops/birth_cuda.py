"""Wrapper of the hand-written CUDA merge kernel of birth (csrc/birth.cu).

``merge_blocks_cuda`` is the merge stage of ``ops.birth._insert_core`` in
one launch: the counterpart of the merge that XLA fuses out of the JAX
package's ``_insert_core`` (``semantic_dsp_map_tpu/ops/birth.py:279-402``).
It takes the arguments of ``ops.birth.merge_blocks_plain``, its oracle, and
has the same effect: the target blocks' rows of the store are updated IN
PLACE and the accepted count comes back as a 0-d int64 device tensor (no
host read, so the launch can be captured into a CUDA graph).  It takes
CUDA tensors only: ``ops.birth.merge_blocks`` decides between it and the
plain version by the store's device, and imports this module only for a
store on the card.  Bound and design: see the note at the top of
csrc/birth.cu.

``merge_blocks_accepted_cuda`` runs the kernel's instance that also writes
which staged candidate was accepted, a byte a staged slot: what the JAX
package's ``insert_particles`` reads (``ops.birth.insert_particles``).

``merge_blocks_cuda.launches`` and ``merge_blocks_accepted_cuda.launches``
count each instance's launches.
"""

from __future__ import annotations

import torch

from ..config import MapConfig
from ..state import Particles
from . import cuda_lib
from .birth import Staged
from .blocks import ActiveBlocks, block_layout

_FIELDS = ("px", "py", "pz", "weight", "label", "track", "status", "forget", "stamp")
#: The staged buffers' names in a refusal (``Staged``'s fields, told apart
#: from the store's).
_STAGED = tuple("in_" + name for name in Staged._fields)


def _merge_args(cfg: MapConfig, flat: Particles, blocks: ActiveBlocks, vox_axis: torch.Tensor,
                staged: Staged):
    """(device index, shape [A, bv, K], the checked pointers of the store,
    vox_axis, ids and staged buffers, the trailing ints A, bv, K, nb).  A
    tensor that is not on the store's CUDA device raises ValueError."""
    index = flat.px.get_device()
    if index < 0:
        raise ValueError(f"px: expected a CUDA tensor, got {flat.px.device}")
    K = cfg.slots_per_voxel
    n = flat.px.shape
    V = n[0] // K
    bv, _nb_full, _spb = block_layout(cfg)
    A = blocks.ids.shape[0]
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8
    fields = [getattr(flat, name) for name in _FIELDS]
    ptrs = cuda_lib.pointers(index, f32, n, fields[:4], _FIELDS[:4])
    ptrs += cuda_lib.pointers(index, u8, n, fields[4:5], _FIELDS[4:5])
    ptrs += cuda_lib.pointers(index, i32, n, fields[5:6], _FIELDS[5:6])
    ptrs += cuda_lib.pointers(index, u8, n, fields[6:8], _FIELDS[6:8])
    ptrs += cuda_lib.pointers(index, i32, n, fields[8:], _FIELDS[8:])
    ptrs += cuda_lib.pointers(index, i32, (V,), (vox_axis,), ("vox_axis",))
    ptrs += cuda_lib.pointers(index, torch.int64, (A,), (blocks.ids,), ("ids",))
    shape = (A, bv, K)
    ptrs += cuda_lib.pointers(index, f32, shape, staged[:4], _STAGED[:4])
    ptrs += cuda_lib.pointers(index, i32, shape, staged[4:], _STAGED[4:])
    return index, shape, ptrs, (A, bv, K, V // bv)


def _trigger(cfg: MapConfig) -> int:
    return (1 << cfg.max_particle_num_per_voxel_n) >> 1


@cuda_lib.counted
def merge_blocks_cuda(cfg: MapConfig, flat: Particles, blocks: ActiveBlocks,
                      vox_axis: torch.Tensor, staged: Staged, resample_targets: bool,
                      want_accepted: bool = False):
    """(flat, accepted count); see ops.birth.merge_blocks_plain.  Works on
    a rank's slab as on the whole store: the voxel count is the store's.  A
    tensor that is not on the store's CUDA device raises ValueError.  With
    ``want_accepted`` the kernel's instance that also writes which staged
    candidate was accepted runs instead (``merge_blocks_accepted_cuda``,
    counted there): (flat, accepted count, bool [A, bv, K])."""
    if want_accepted:
        return merge_blocks_accepted_cuda(cfg, flat, blocks, vox_axis, staged, resample_targets)
    index, _shape, ptrs, dims = _merge_args(cfg, flat, blocks, vox_axis, staged)
    accepted = torch.zeros((), dtype=torch.int64, device=flat.px.device)
    err = cuda_lib.entry.dsp_merge_blocks(
        *ptrs, accepted.data_ptr(), *dims, int(resample_targets), _trigger(cfg),
        cuda_lib.stream_ptr(index),
    )
    if err:
        raise cuda_lib.error(err, "dsp_merge_blocks")
    merge_blocks_cuda.launches += 1
    return flat, accepted


@cuda_lib.counted
def merge_blocks_accepted_cuda(cfg: MapConfig, flat: Particles, blocks: ActiveBlocks,
                               vox_axis: torch.Tensor, staged: Staged, resample_targets: bool):
    """The merge with the per-candidate acceptance (the instance of
    csrc/birth.cu's kernel that writes a byte a staged slot): (flat,
    accepted count, accepted bool [A, bv, K]), the plain version's
    ``merge_blocks_plain(..., want_accepted=True)``.  What
    ``ops.birth.insert_particles`` runs on the card."""
    index, shape, ptrs, dims = _merge_args(cfg, flat, blocks, vox_axis, staged)
    accepted = torch.zeros((), dtype=torch.int64, device=flat.px.device)
    mask = torch.empty(shape, dtype=torch.uint8, device=flat.px.device)
    err = cuda_lib.entry.dsp_merge_blocks_accepted(
        *ptrs, accepted.data_ptr(), mask.data_ptr(), *dims, int(resample_targets),
        _trigger(cfg), cuda_lib.stream_ptr(index),
    )
    if err:
        raise cuda_lib.error(err, "dsp_merge_blocks_accepted")
    merge_blocks_accepted_cuda.launches += 1
    return flat, accepted, mask.view(torch.bool)
