"""The PyTorch port's frame step against the JAX package, end to end.

- the 10-frame dynamic scene of test_full_frame_oracle.py through both
  SemanticDSPMaps: every StepDiagnostics counter and all integer state
  equal, particle floats within the oracle test's own tolerances;
- the committed replay data/replay_tiny through the port's ``update()``,
  equal to EXPECTED.json;
- the port's jax-free copies of config, labels and pack_frame equal to the
  originals, on edge frames and packed again into a held buffer, which
  allocates no array of the image's size.
"""

import dataclasses
import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu import config as jconfig
from semantic_dsp_map_tpu.datasets import NpzSequence
from semantic_dsp_map_tpu.frontend import build_frame_input as j_build
from semantic_dsp_map_tpu.frontend import pack_frame as j_pack
from semantic_dsp_map_tpu.frontend import static_label_table as j_static_table
from semantic_dsp_map_tpu.labels import LabelRegistry as JLabelRegistry
from semantic_dsp_map_tpu.map import unpack_frame as j_unpack

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch import config as tconfig
from semantic_dsp_map_tpu_torch.frontend import build_frame_input as t_build
from semantic_dsp_map_tpu_torch.benchmarks.scenes import synth_vkitti2_frame
from semantic_dsp_map_tpu_torch.frontend import PackedFrame
from semantic_dsp_map_tpu_torch.frontend import pack_frame as t_pack
from semantic_dsp_map_tpu_torch.frontend import static_label_table as t_static_table
from semantic_dsp_map_tpu_torch.map import unpack_frame as t_unpack
from semantic_dsp_map_tpu_torch.state import map_state_to_numpy

from torch_parity import assert_states_match, dynamic_scene, jax_state_to_numpy, static_camera

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "replay_tiny")

SCENE_PARAMS = dict(
    if_consider_depth_noise=True,
    nb_ptc_num_per_point=1,
    depth_noise_model_zero_order=0.2,
    prediction_stddev=0.0,  # determinism: no rigid-move jitter
)


def test_dynamic_scene_matches_jax():
    _hold_scene_against_jax(dynamic_scene)


def test_dynamic_scene_static_camera_matches_jax():
    """With the camera at rest born particles reproject onto integer pixel
    coordinates: this held only once the port's cloud had the jitted JAX
    cloud's bits (tests/test_torch_projection.py)."""
    _hold_scene_against_jax(static_camera(dynamic_scene))


def _hold_scene_against_jax(scene):
    jm = J.SemanticDSPMap(J.config.tiny_test_config(), J.FilterParams(**SCENE_PARAMS))
    tm = T.SemanticDSPMap(T.tiny_test_config(), T.FilterParams(**SCENE_PARAMS), device="cpu")
    moved = 0
    for t in range(10):
        d, m, p, q, tt = scene(jm.cfg, t, J.MaskKpts)
        jr, jd = jm.update_from_frame(j_build(jm.cfg, jm.registry, d, m, p, q, tt))
        d, m, p, q, tt = scene(tm.cfg, t, T.MaskKpts)
        tr, td = tm.update_from_frame(t_build(tm.cfg, tm.registry, d, m, p, q, tt))

        msg = f"frame {t}"
        assert {k: int(v) for k, v in td._asdict().items()} == {
            k: int(v) for k, v in jd._asdict().items()
        }, msg
        for name in ("occ", "label", "track"):
            np.testing.assert_array_equal(
                getattr(tr, name).numpy(), np.asarray(getattr(jr, name)), err_msg=f"{name} {msg}"
            )
        np.testing.assert_allclose(
            tr.weight_sum.numpy(), np.asarray(jr.weight_sum), rtol=2e-4, atol=1e-6,
            err_msg=f"weight_sum {msg}",
        )
        assert_states_match(jax_state_to_numpy(jm.state), map_state_to_numpy(tm.state), msg)
        moved += int(td.moved_count)
    # the tracked car must actually have been moved by the rigid-move stage
    assert moved > 0


def test_committed_replay_matches_expected():
    from semantic_dsp_map_tpu_torch.tools.make_replay_sequence import replay_params

    with open(os.path.join(DATA, "EXPECTED.json")) as f:
        expected = json.load(f)
    params = T.FilterParams(**dataclasses.asdict(replay_params()))
    dsp = T.SemanticDSPMap(T.tiny_test_config(), params, device="cpu")
    seq = NpzSequence(DATA)
    assert len(seq) == expected["n_frames"]

    got = []
    for i, frame in enumerate(seq):
        if i < expected["drop_first"]:
            continue
        masks = [T.MaskKpts(**dataclasses.asdict(mk)) for mk in frame.masks]
        result, diag = dsp.update(frame.depth, masks, frame.cam_pos, frame.cam_quat, frame.time)
        occ = result.occ.numpy()
        got.append(
            dict(
                index=frame.index,
                occupied=int((occ == 1).sum()),
                free=int((occ == 0).sum()),
                unknown=int((occ == -1).sum()),
                visible=int(diag.visible_count),
                born=int(diag.born_count),
                moved=int(diag.moved_count),
            )
        )
    assert got == expected["frames"]


@pytest.mark.parametrize(
    "preset",
    ["kitti360_config", "coda_config", "virtual_kitti2_config", "zed2_config", "tiny_test_config"],
)
def test_config_copy_equal(preset):
    a = dataclasses.asdict(getattr(jconfig, preset)())
    b = dataclasses.asdict(getattr(tconfig, preset)())
    assert a == b
    assert dataclasses.asdict(jconfig.FilterParams()) == dataclasses.asdict(tconfig.FilterParams())
    consts = [n for n in dir(jconfig) if n.isupper()]
    assert {n: getattr(jconfig, n) for n in consts} == {n: getattr(tconfig, n) for n in consts}


def test_labels_copy_equal():
    a, b = JLabelRegistry.default(), T.LabelRegistry.default()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for table in ("static_pixel_value_to_instance_table", "instance_to_label_id_table",
                  "label_color_table"):
        np.testing.assert_array_equal(getattr(a, table)(), getattr(b, table)())
    np.testing.assert_array_equal(j_static_table(a), t_static_table(b))


def _pack_scene(cfg, t=1):
    H, W = cfg.image_height, cfg.image_width
    rng = np.random.RandomState(t)
    depth = (1.0 + rng.rand(H, W) * 3).astype(np.float32)
    static = np.full((H, W), 6, np.uint8)
    car = np.zeros((H, W), np.uint8)
    car[H // 3 : H // 2, W // 4 : W // 2] = 1
    kpts = np.array([[0.3, 0.1, 1.9], [0.8, 0.1, 1.9], [0.3, -0.2, 1.9],
                     [0.8, -0.2, 1.9], [0.3, 0.1, 2.2]], np.float32)
    return depth, static, car, kpts


def _box(H, W, rows, cols):
    """A uint8 mask set over the fractions ``rows`` x ``cols`` of the image."""
    m = np.zeros((H, W), np.uint8)
    m[int(rows[0] * H) : int(rows[1] * H), int(cols[0] * W) : int(cols[1] * W)] = 1
    return m


def _car(track, mask, kpts, n_prev=None, label="Car"):
    prev = kpts - 0.05 if n_prev is None else kpts[:n_prev] - 0.05
    return dict(track_id=track, label=label, mask=mask, kpts_current=kpts, kpts_previous=prev)


def _static_and_car(H, W, static, car, kpts):
    return [dict(track_id=65535, label="static", mask=static), _car(7, car, kpts)]


def _three_movers(H, W, static, car, kpts):
    return [dict(track_id=65535, label="static", mask=static),
            _car(4, _box(H, W, (0.1, 0.3), (0.1, 0.3)), kpts + 1.0),
            _car(5, _box(H, W, (0.5, 0.9), (0.6, 0.9)), kpts[:3], label="Person"),
            _car(6, car, kpts)]


def _static_255(H, W, static, car, kpts):
    values = np.random.RandomState(3).randint(0, 256, (H, W)).astype(np.uint8)
    values[0, :4] = (0, 254, 255, 5)
    return [dict(track_id=65535, label="static", mask=values), _car(7, car, kpts)]


#: Frames packed by ``test_pack_frame_bytes_equal``: (preset, its
#: overrides, the frame's masks as MaskKpts fields from (H, W, static, car,
#: keypoints)).  Every frame is also packed into a held buffer that held
#: :func:`_three_movers` before.
PACK_CASES = {
    "tiny_test_config": ("tiny_test_config", {}, _static_and_car),
    "virtual_kitti2_config": ("virtual_kitti2_config", {}, _static_and_car),
    "zed2_config": ("zed2_config", {}, _static_and_car),
    "overlapping_movers": ("tiny_test_config", {}, lambda H, W, static, car, kpts: [
        dict(track_id=65535, label="static", mask=static), _car(7, car, kpts),
        _car(9, _box(H, W, (0.25, 0.4), (0.4, 0.6)), kpts + 0.5)]),
    "static_holds_255": ("virtual_kitti2_config", {}, _static_255),
    "track_above_max_movable": ("tiny_test_config", {}, lambda H, W, static, car, kpts: [
        dict(track_id=65535, label="static", mask=static), _car(65523 + 100, car, kpts),
        _car(65523, _box(H, W, (0.7, 0.8), (0.1, 0.2)), kpts)]),
    "keypoint_mismatch_dropped": ("tiny_test_config", {}, lambda H, W, static, car, kpts: [
        dict(track_id=65535, label="static", mask=static), _car(8, car, kpts, n_prev=4),
        _car(9, _box(H, W, (0.7, 0.8), (0.1, 0.2)), kpts)]),
    "more_movers_than_slots": ("tiny_test_config", {}, lambda H, W, static, car, kpts: [
        dict(track_id=65535, label="static", mask=static)] + [
        _car(10 + k, _box(H, W, (0.05 * k, 0.05 * k + 0.1), (0.08 * k, 0.08 * k + 0.1)),
             kpts + k) for k in range(11)]),
    "odd_image": ("tiny_test_config", dict(image_width=33, image_height=25), _static_and_car),
    "three_movers_then_one": ("zed2_config", {}, lambda H, W, static, car, kpts: [
        _car(7, car, kpts)]),
    "masks_not_uint8": ("tiny_test_config", {}, lambda H, W, static, car, kpts: [
        dict(track_id=65535, label="static", mask=static.astype(np.int32)),
        _car(7, car.astype(bool), kpts)]),
    "instances_off": ("tiny_test_config", dict(consider_instance=False), _three_movers),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_frame_bytes_equal(case):
    """``pack_frame`` and a held buffer packed again give the JAX package's
    bytes; the unpacked path (``build_frame_input``) and the device-side
    decode agree with the JAX package's field for field."""
    preset, overrides, scene = PACK_CASES[case]
    cfg_j = getattr(jconfig, preset)(**overrides)
    cfg_t = getattr(tconfig, preset)(**overrides)
    depth, static, car, kpts = _pack_scene(cfg_j)
    H, W = cfg_j.image_height, cfg_j.image_width

    def masks(cls, make=scene):
        return [cls(**m) for m in make(H, W, static, car, kpts)]

    pos = np.array([0.1, -0.05, 0.4], np.float32)
    quat = np.array([1.0, 0, 0, 0], np.float32)
    registry = T.LabelRegistry.default()
    jb = j_pack(cfg_j, JLabelRegistry.default(), depth, masks(J.MaskKpts), pos, quat, 0.7)
    tb = t_pack(cfg_t, registry, depth, masks(T.MaskKpts), pos, quat, 0.7)
    assert jb.dtype == tb.dtype and jb.tobytes() == tb.tobytes()

    held = PackedFrame(cfg_t)
    held.pack(cfg_t, registry, depth + 1, masks(T.MaskKpts, _three_movers), -pos, quat, 0.6)
    hb = held.pack(cfg_t, registry, depth, masks(T.MaskKpts), pos, quat, 0.7)
    assert hb is held.buf and hb.tobytes() == jb.tobytes()

    jf = j_build(cfg_j, JLabelRegistry.default(), depth, masks(J.MaskKpts), pos, quat, 0.7)
    tf = t_build(cfg_t, registry, depth, masks(T.MaskKpts), pos, quat, 0.7)
    for name in tf._fields:
        np.testing.assert_array_equal(getattr(tf, name), np.asarray(getattr(jf, name)),
                                      err_msg=name)

    # the device-side decode agrees field for field
    jf = j_unpack(cfg_j, j_static_table(JLabelRegistry.default()), jb)
    tf = t_unpack(
        cfg_t, torch.from_numpy(t_static_table(T.LabelRegistry.default())), torch.from_numpy(tb)
    )
    for name in tf._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(tf, name)), np.asarray(getattr(jf, name)), err_msg=name
        )


def test_a_held_buffer_packs_a_vkitti2_frame_with_no_image_allocated():
    """After one warm frame, packing a VKITTI2 frame (the shape of the
    benchmark's ``drive`` frames: a uint8 static mask and one car) into a
    held buffer allocates under 128 KiB at its peak, glibc's mmap
    threshold in a fresh process: no array of the image's size is made,
    and the bytes are ``pack_frame``'s."""
    cfg = tconfig.virtual_kitti2_config()
    registry = T.LabelRegistry.default()
    held = PackedFrame(cfg)
    frames = [synth_vkitti2_frame(cfg, t, T.MaskKpts) for t in (0, 5)]
    held.pack(cfg, registry, *frames[0], 0.0)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        buf = held.pack(cfg, registry, *frames[1], 0.5)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 128 * 1024, peak
    assert buf.tobytes() == t_pack(cfg, registry, *frames[1], 0.5).tobytes()


def test_the_packed_raster_refuses_a_track_id_outside_u16():
    """The packed raster holds u16 track ids (the wire schema's ``uint16
    track_id``): a negative one is refused, where it was once folded into
    the next pixel's half of its word; the unpacked i32 raster keeps it."""
    cfg = tconfig.tiny_test_config()
    registry = T.LabelRegistry.default()
    depth, static, car, kpts = _pack_scene(cfg)

    def masks():
        return [T.MaskKpts(track_id=65535, label="static", mask=static),
                T.MaskKpts(track_id=-3, label="Car", mask=car, kpts_current=kpts,
                           kpts_previous=kpts)]

    pose = (np.zeros(3, np.float32), np.array([1.0, 0, 0, 0], np.float32))
    with pytest.raises(ValueError, match="track id -3"):
        t_pack(cfg, registry, depth, masks(), *pose)
    raster = T.rasterize_masks(cfg, registry, masks())
    assert (raster[car > 0] == -3).all() and (raster[car == 0] != -3).all()
