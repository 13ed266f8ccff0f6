"""The port's dataset readers against the JAX package's, on the small
on-disk trees of tests/test_datasets.py (official layouts, written by its
PNG writer): equal decoded images, poses and frames, equal ``pack_frame``
bytes, the sequences replayed end to end through both maps, and npz frames
crossing between the packages in both directions."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu import datasets as jds
from semantic_dsp_map_tpu import replay as jreplay
from semantic_dsp_map_tpu.frontend import pack_frame as j_pack

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch import config as tconfig
from semantic_dsp_map_tpu_torch import datasets as tds
from semantic_dsp_map_tpu_torch import replay as treplay
from semantic_dsp_map_tpu_torch.frontend import pack_frame as t_pack

from test_datasets import _tiny_depth, write_png

torch.set_num_threads(2)

#: One particle per point and no jitter: both maps are deterministic.
PARAMS = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
              depth_noise_model_zero_order=0.2, prediction_stddev=0.0)


def _assert_frames_equal(jf, tf, cfg_j, cfg_t):
    """Two Frames equal field for field, and equal as packed buffers."""
    assert (jf.index, jf.time) == (tf.index, tf.time)
    for name in ("depth", "cam_pos", "cam_quat"):
        a, b = getattr(jf, name), getattr(tf, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert len(jf.masks) == len(tf.masks)
    for jm, tm in zip(jf.masks, tf.masks):
        assert isinstance(tm, T.MaskKpts) and isinstance(jm, J.MaskKpts)
        assert (jm.track_id, jm.label) == (tm.track_id, tm.label)
        np.testing.assert_array_equal(jm.mask, tm.mask)
        for name in ("kpts_current", "kpts_previous"):
            a, b = getattr(jm, name), getattr(tm, name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    jb = j_pack(cfg_j, J.LabelRegistry.default(), jf.depth, jf.masks, jf.cam_pos, jf.cam_quat, jf.time)
    tb = t_pack(cfg_t, T.LabelRegistry.default(), tf.depth, tf.masks, tf.cam_pos, tf.cam_quat, tf.time)
    assert jb.dtype == tb.dtype and jb.tobytes() == tb.tobytes()


def _replay_both(cfg_j, cfg_t, jseq, tseq, tmp_path):
    """run_replay through both maps: equal summaries' frame counts, equal
    occupancy, PLY files with equal vertices."""
    jm = J.SemanticDSPMap(cfg_j, J.FilterParams(**PARAMS), J.LabelRegistry.default())
    tm = T.SemanticDSPMap(cfg_t, T.FilterParams(**PARAMS), T.LabelRegistry.default(), device="cpu")
    js, jr = jreplay.run_replay(jm, jseq, out_dir=str(tmp_path / "j"), verbose=False)
    ts, tr = treplay.run_replay(tm, tseq, out_dir=str(tmp_path / "t"), verbose=False)
    assert ts["frames"] == js["frames"]
    np.testing.assert_array_equal(tr.occ.numpy(), np.asarray(jr.occ))
    assert int((tr.occ == 1).sum()) > 0
    from semantic_dsp_map_tpu_torch.io import read_ply

    jx, jc = read_ply(str(tmp_path / "j" / "final_occupied.ply"))
    tx, tc = read_ply(str(tmp_path / "t" / "final_occupied.ply"))
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tc, jc)
    return ts


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
def test_png_reader_equal(tmp_path, kind):
    rng = np.random.RandomState(0)
    arr = {
        "gray8": rng.randint(0, 256, (24, 32)).astype(np.uint8),
        "gray16": rng.randint(0, 65536, (24, 32)).astype(np.uint16),
        "rgb8": rng.randint(0, 256, (24, 32, 3)).astype(np.uint8),
    }[kind]
    path = str(tmp_path / "img.png")
    write_png(path, arr)
    got = tds._read_png(path)
    np.testing.assert_array_equal(got, arr)
    want = jds._read_png(path)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("numbers", [17, 13])
def test_kitti360_pose_formats_equal(tmp_path, numbers):
    a = 0.3
    pose = np.eye(4)
    pose[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    pose[:3, 3] = [1.5, -2.0, 0.7]
    np.testing.assert_array_equal(tds.KITTI360_CAM_TO_IMU, jds.KITTI360_CAM_TO_IMU)
    if numbers == 13:
        rows = (pose @ np.linalg.inv(jds.KITTI360_CAM_TO_IMU))[:3]
    else:
        rows = pose
    path = tmp_path / "poses.txt"
    with open(path, "w") as f:
        f.write("\n5 " + " ".join(str(v) for v in rows.reshape(-1)) + "\n")
        f.write("9 " + " ".join(str(v) for v in rows.reshape(-1)) + "\n")
    got, want = tds.read_kitti360_poses(str(path)), jds.read_kitti360_poses(str(path))
    assert [p[0] for p in got] == [5, 9] == [p[0] for p in want]
    for g, w in zip(got, want):
        assert g[1].tobytes() == w[1].tobytes() and g[2].tobytes() == w[2].tobytes()
    np.testing.assert_allclose(got[0][1], pose[:3, 3], atol=1e-5)
    np.testing.assert_allclose(got[0][2], tds.rotation_to_quat_wxyz(pose[:3, :3]), atol=1e-5)
    with open(path, "a") as f:
        f.write("7 1 2 3\n")
    with pytest.raises(ValueError, match="invalid pose line"):
        tds.read_kitti360_poses(str(path))


@pytest.mark.parametrize("seed", range(4))
def test_rotation_to_quat_equal(seed):
    """All four branches of Shepperd's method, against the JAX package's."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    q *= np.sign(np.linalg.det(q))
    flips = [np.diag([1, 1, 1]), np.diag([1, -1, -1]), np.diag([-1, 1, -1]), np.diag([-1, -1, 1])]
    for f in flips:
        r = q @ f
        np.testing.assert_array_equal(tds.rotation_to_quat_wxyz(r), jds.rotation_to_quat_wxyz(r))
    np.testing.assert_array_equal(
        tds.rotation_to_quat_wxyz(np.diag([-1.0, -1.0, 1.0])), jds.rotation_to_quat_wxyz(np.diag([-1.0, -1.0, 1.0])))


def test_kitti360_sequence_end_to_end(tmp_path):
    cfg_j = J.config.tiny_test_config(consider_instance=False)
    cfg_t = T.tiny_test_config(consider_instance=False)
    H, W = cfg_t.image_height, cfg_t.image_width
    ddir, sdir = tmp_path / "depth", tmp_path / "semantic"
    os.makedirs(ddir), os.makedirs(sdir)
    lines = []
    for t in range(4):
        name = str(t).zfill(10)
        np.save(str(ddir / (name + ".npy")), _tiny_depth(cfg_t, t))
        sem = np.full((H, W), 5, np.uint8)
        sem[: H // 2] = 4
        write_png(str(sdir / (name + ".png")), sem)
        pose = np.eye(4)
        pose[:3, 3] = [0, 0, 0.1 * t]
        lines.append(f"{t} " + " ".join(str(v) for v in pose.reshape(-1)))
    with open(tmp_path / "poses.txt", "w") as f:
        f.write("\n".join(lines) + "\n")

    args = (str(ddir), str(sdir), str(tmp_path / "poses.txt"))
    jseq, tseq = jds.Kitti360Sequence(*args), tds.Kitti360Sequence(*args)
    jframes, tframes = list(jseq), list(tseq)
    assert len(tseq) == len(jseq) == len(tframes) == len(jframes) == 6
    assert tframes[0].index == tframes[1].index == 0  # repeat_first
    for jf, tf in zip(jframes, tframes):
        _assert_frames_equal(jf, tf, cfg_j, cfg_t)
    assert _replay_both(cfg_j, cfg_t, jseq, tseq, tmp_path)["frames"] == 4
    assert len(list(tds.Kitti360Sequence(*args, start=1, stop=2, repeat_first=0))) == 2


def test_vkitti2_sequence_end_to_end(tmp_path):
    cfg_j, cfg_t = J.config.tiny_test_config(), T.tiny_test_config()
    H, W = cfg_t.image_height, cfg_t.image_width
    scene = tmp_path / "Scene01" / "clone"
    cam = "Camera_0"
    for sub in ["depth", "classSegmentation", "instanceSegmentation"]:
        os.makedirs(scene / "frames" / sub / cam)
    ext = ["frame cameraID r1,1 r1,2 ..."]
    for t in range(4):
        depth_cm = np.clip(_tiny_depth(cfg_t, t) * 100.0, 0, 65535).astype(np.uint16)
        write_png(str(scene / "frames" / "depth" / cam / f"depth_{t:05d}.png"), depth_cm)
        cls = np.zeros((H, W, 3), np.uint8)
        cls[:, :] = (100, 60, 100)      # Road
        cls[: H // 2] = (90, 200, 255)  # Sky
        car = np.zeros((H, W), bool)
        car[H // 3 : H // 3 + 10, 8 + t : 20 + t] = True
        cls[car] = (255, 127, 80)       # Car
        inst = np.zeros((H, W), np.uint8)
        inst[car] = 3
        write_png(str(scene / "frames" / "classSegmentation" / cam / f"classgt_{t:05d}.png"), cls)
        write_png(str(scene / "frames" / "instanceSegmentation" / cam / f"instancegt_{t:05d}.png"), inst)
        w2c = np.eye(4)
        w2c[:3, 3] = [0, 0, -0.1 * t]
        ext.append(f"{t} 0 " + " ".join(str(v) for v in w2c.reshape(-1)))
        ext.append(f"{t} 1 " + " ".join(str(v) for v in np.eye(4).reshape(-1)))
    with open(scene / "extrinsic.txt", "w") as f:
        f.write("\n".join(ext) + "\n")

    assert tds.VKITTI2_CLASS_COLORS == jds.VKITTI2_CLASS_COLORS
    jseq = jds.VirtualKitti2Sequence(str(scene), registry=J.LabelRegistry.default())
    tseq = tds.VirtualKitti2Sequence(str(scene), registry=T.LabelRegistry.default())
    jframes, tframes = list(jseq), list(tseq)
    assert len(tseq) == len(jseq) == len(tframes) == 4
    for jf, tf in zip(jframes, tframes):
        _assert_frames_equal(jf, tf, cfg_j, cfg_t)
    inst_masks = [m for m in tframes[0].masks if m.label != "static"]
    assert len(inst_masks) == 1 and inst_masks[0].track_id == 3
    assert inst_masks[0].kpts_current.shape == (5, 3)
    assert _replay_both(cfg_j, cfg_t, jseq, tseq, tmp_path)["frames"] == 2


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_npz_frames_cross_between_packages(tmp_path, writer):
    """A frame written by one package's save_npz_frame is read by the other's
    NpzSequence and packs to the bytes of the frame itself (u8 masks, f32
    keypoints, track id 65535 for the static mask)."""
    from torch_parity import dynamic_scene

    cfg_j, cfg_t = J.config.tiny_test_config(), T.tiny_test_config()
    W_mod, W_frame, W_mask = (jds, jds.Frame, J.MaskKpts) if writer == "jax" else (tds, tds.Frame, T.MaskKpts)
    R_mod = tds if writer == "jax" else jds
    frames = []
    for t in range(3):
        d, m, p, q, tt = dynamic_scene(cfg_t, t, W_mask)
        if t == 2:  # a second instance with fewer keypoints (padded in the file)
            m.append(W_mask(track_id=9, label="Van", mask=(m[1].mask * 0 + (np.arange(cfg_t.width) > 28)).astype(np.uint8),
                            kpts_current=m[1].kpts_current[:3] + 1.0, kpts_previous=m[1].kpts_current[:3] + 0.9))
        frames.append(W_frame(d, m, p, q, tt, t))
        W_mod.save_npz_frame(str(tmp_path / "seq"), t, frames[-1])
    back = list(R_mod.NpzSequence(str(tmp_path / "seq")))
    assert len(back) == 3 == len(R_mod.NpzSequence(str(tmp_path / "seq")))
    jreg, treg = J.LabelRegistry.default(), T.LabelRegistry.default()
    for f, b in zip(frames, back):
        assert b.index == f.index and b.time == float(np.float32(f.time))
        assert [(m.track_id, m.label) for m in b.masks] == [(m.track_id, m.label) for m in f.masks]
        assert b.masks[0].track_id == 65535 and b.masks[0].mask.dtype == np.uint8
        assert all(m.kpts_current.dtype == np.float32 for m in b.masks[1:])
        pack_w, cfg_w, reg_w = (j_pack, cfg_j, jreg) if writer == "jax" else (t_pack, cfg_t, treg)
        pack_r, cfg_r, reg_r = (t_pack, cfg_t, treg) if writer == "jax" else (j_pack, cfg_j, jreg)
        if len(f.masks) == 2:  # equal keypoint counts: nothing was padded
            want = pack_w(cfg_w, reg_w, f.depth, f.masks, f.cam_pos, f.cam_quat, f.time)
            got = pack_r(cfg_r, reg_r, b.depth, b.masks, b.cam_pos, b.cam_quat, b.time)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        else:
            np.testing.assert_array_equal(b.masks[2].kpts_current[:3], f.masks[2].kpts_current)
            np.testing.assert_array_equal(b.masks[2].kpts_current[3:], 0)


def test_filter_params_from_yaml_equal(tmp_path):
    """replay's --options reader gives the JAX package's parameters."""
    path = tmp_path / "options.yaml"
    path.write_text(
        "detection_probability: 0.8\nnoise_number: 0.2\nnb_ptc_num_per_point: 1\n"
        "occupancy_threshold: 0.15\nmax_forget_count: 7\nif_consider_depth_noise: true\n"
        "depth_noise_model_zero_order: 0.3\nif_output_freespace: true\nunknown_key: 3\n"
    )
    got = dataclasses.asdict(tconfig.filter_params_from_yaml(str(path)))
    want = dataclasses.asdict(J.config.filter_params_from_yaml(str(path)))
    assert got == want
    assert got["nb_ptc_num_per_point"] == 1 and got["if_output_freespace"] is True
