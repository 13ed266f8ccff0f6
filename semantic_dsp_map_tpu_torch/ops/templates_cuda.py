"""Wrappers of the hand-written CUDA kernels of template mode's every-frame
passes (csrc/templates.cu).

``template_gate_cuda`` computes ``template_engine.template_gate`` and
``delete_matched_cuda`` ``template_engine.delete_matched_plain``.  They
replace no TPU kernel: XLA fuses the JAX package's gate loop and masked
delete.  On CUDA tensors they launch the kernels; on CPU tensors they run
those plain versions, their oracles, which take the same arguments.  Bound
and design: see the note at the top of csrc/templates.cu.

``template_gate_cuda.launches`` / ``delete_matched_cuda.launches`` count
kernel launches.
"""

from __future__ import annotations

import torch

from . import cuda_lib

#: Columns of the gate's scratch (csrc/templates.cu's GATE_COLUMNS).
_GATE_COLUMNS = 6

_FLAGS = ("valid", "to_match_previous", "moving", "has_moved_record", "to_match_templates")


@cuda_lib.counted
def template_gate_cuda(car_label: int, objects, cloud) -> torch.Tensor:
    """i32[O, 8]; see template_engine.template_gate."""
    index = cloud.track.get_device()
    if index < 0:  # the CPU: the plain version (whose module imports this one)
        from ..template_engine import template_gate

        return template_gate(car_label, objects, cloud)
    hw = cloud.track.shape
    O = objects.valid.shape[0]
    ptrs = cuda_lib.pointers(index, torch.int32, hw, (cloud.track,), ("cloud.track",))
    ptrs += cuda_lib.pointers(index, torch.bool, hw, (cloud.valid,), ("cloud.valid",))
    ptrs += cuda_lib.pointers(index, torch.float32, (*hw, 3), (cloud.pos,), ("cloud.pos",))
    ptrs += cuda_lib.pointers(index, torch.bool, (O,), [getattr(objects, f) for f in _FLAGS],
                              [f"objects.{f}" for f in _FLAGS])
    ptrs += cuda_lib.pointers(index, torch.int32, (O,), (objects.track_id, objects.label),
                              ("objects.track_id", "objects.label"))
    acc = torch.empty((_GATE_COLUMNS, O), dtype=torch.int32, device=cloud.track.device)
    gate = torch.empty((O, 8), dtype=torch.int32, device=cloud.track.device)
    err = cuda_lib.entry.dsp_template_gate(
        *ptrs, acc.data_ptr(), gate.data_ptr(), hw.numel(), O, int(car_label),
        cuda_lib.stream_ptr(index),
    )
    if err:
        raise cuda_lib.error(err, "dsp_template_gate")
    template_gate_cuda.launches += 1
    return gate


@cuda_lib.counted
def delete_matched_cuda(track, status, good, tid) -> None:
    """``status`` set to STATUS_INVALID in place; see
    template_engine.delete_matched_plain.  The kernel loads 16 bytes of
    track at a time: a track that does not start on a 16-byte boundary
    raises (whole tensors do)."""
    index = track.get_device()
    if index < 0:  # the CPU: the plain version (whose module imports this one)
        from ..template_engine import delete_matched_plain

        delete_matched_plain(track, status, good, tid)
        return
    (track_p,) = cuda_lib.pointers(index, torch.int32, None, (track,), ("track",))
    (status_p,) = cuda_lib.pointers(index, torch.uint8, track.shape, (status,), ("status",))
    (good_p,) = cuda_lib.pointers(index, torch.bool, None, (good,), ("good",))
    (tid_p,) = cuda_lib.pointers(index, torch.int32, good.shape, (tid,), ("tid",))
    err = cuda_lib.entry.dsp_delete_matched(track_p, status_p, good_p, tid_p, good.numel(),
                                            track.numel(), cuda_lib.stream_ptr(index))
    if err:
        raise cuda_lib.error(err, "dsp_delete_matched")
    delete_matched_cuda.launches += 1
