"""Synthetic scenes and runtime parameters of the bench's cells (counterpart
of the scene functions in the JAX package's ``bench.py``).

Every scene is ``synth(cfg, t, mask_cls=MaskKpts, ...) -> (depth, masks,
cam_pos, cam_quat)`` for frame ``t``, numpy only, seeded by ``t``.  The
order of the generator's draws and every float64-to-float32 step follow
``bench.py``, so a scene's bytes equal the JAX package's.

Trap: at ``tiny_test_config()`` these scenes are empty.  Their depths are
3.5 to 28 m; the tiny grid spans 4 x 2 x 4 m and its depth range ends at
8 m.  A small-size run needs a reduced VKITTI2 or ZED2 config (a quarter of
the image and intrinsics, a smaller grid): ``REDUCED_VKITTI2`` and
``REDUCED_ZED2`` below.
"""

from __future__ import annotations

import numpy as np

from ..frontend import MaskKpts

#: The VKITTI2 preset cut to a size a CPU can step (keyword overrides of
#: ``virtual_kitti2_config``): a quarter of the image and of the intrinsics,
#: 131,072 voxels of 0.5 m, K = 7 as the preset.  The caps are small enough
#: that the hostile scene's 20 cars overflow the move working set.
REDUCED_VKITTI2 = dict(
    voxel_num_axis_x_n=6, voxel_num_axis_y_n=5, voxel_num_axis_z_n=6, voxel_size=0.5,
    camera_fx=725.0087 / 4, camera_fy=725.0087 / 4, camera_cx=620.5 / 4, camera_cy=187.0 / 4,
    image_width=310, image_height=94, max_moving_blocks=8, max_active_blocks=512,
    max_table_entries=1 << 16, max_birth_blocks=512, corner_gather_blocks=256,
)

#: The ZED2 preset cut likewise (overrides of ``zed2_config``; BOOST stays
#: on: 320 x 180 in, 160 x 90 mapped).
REDUCED_ZED2 = dict(
    voxel_num_axis_x_n=6, voxel_num_axis_y_n=4, voxel_num_axis_z_n=6, voxel_size=0.3,
    camera_fx=527.8191528320312 / 4, camera_fy=527.8191528320312 / 4,
    camera_cx=633.9357299804688 / 4, camera_cy=366.3338623046875 / 4,
    image_width=320, image_height=180, max_table_entries=1 << 15, max_active_blocks=256,
    max_birth_blocks=256,
)

#: Runtime parameters of the vkitti2 and vkitti2_hostile cells
#: (cfg/options.yaml semantics with depth noise on; bench.py:322-328).
VK_PARAMS = dict(
    detection_probability=0.98, noise_number=0.001, nb_ptc_num_per_point=1,
    occupancy_threshold=0.5, max_observation_lost_time=5,
    forgetting_rate=1.0, max_forget_count=3, id_transition_probability=0.2,
    if_consider_depth_noise=True,
    depth_noise_model_first_order=0.01, depth_noise_model_zero_order=0.2,
)

#: Runtime parameters of the vkitti2_template cell (bench.py:337-343):
#: VKITTI2 with template matching on.
TPL_PARAMS = dict(
    detection_probability=0.98, noise_number=0.001, nb_ptc_num_per_point=1,
    occupancy_threshold=0.5, max_observation_lost_time=5, if_consider_depth_noise=True,
    depth_noise_model_first_order=0.01, depth_noise_model_zero_order=0.2,
    if_use_template_matching=True, match_score_threshold=0.2,
)

#: Runtime parameters of the zed2 cell (cfg/options_zed2.yaml;
#: bench.py:306-315).
ZED2_PARAMS = dict(
    detection_probability=0.8, noise_number=0.2, nb_ptc_num_per_point=1,
    occupancy_threshold=0.15, max_observation_lost_time=20,
    forgetting_rate=1.0, max_forget_count=5, id_transition_probability=0.5,
    bayesian_movement_distance_threshold=0.2,
    bayesian_movement_probability_threshold=0.3,
    bayesian_movement_increment=0.2, bayesian_movement_decrement=0.05,
    if_consider_depth_noise=True,
    depth_noise_model_first_order=0.02, depth_noise_model_zero_order=0.3,
)

#: Runtime parameters of the coda path.  The JAX package has no runtime YAML
#: for SETTING 1, so these are the ``FilterParams`` defaults with one particle
#: per point and the depth-noise model on.
CODA_PARAMS = dict(nb_ptc_num_per_point=1, if_consider_depth_noise=True)


def synth_zed2_frame(cfg, t, mask_cls=MaskKpts):
    """ZED2-like frame at full sensor resolution (update() BOOST-resizes):
    ground, a building above the horizon and a tracked person with 3D-bbox
    corner keypoints."""
    H, W = cfg.image_height, cfg.image_width
    rng = np.random.RandomState(t)
    v = np.arange(H, dtype=np.float32)[:, None]
    depth = np.full((H, W), 9.0, np.float32)
    ground = cfg.camera_fy * 1.2 / np.maximum(v - cfg.camera_cy, 1e-3)
    depth = np.minimum(depth, np.where(v > cfg.camera_cy, ground, depth))
    depth += rng.randn(H, W).astype(np.float32) * 0.03
    static = np.full((H, W), 6, np.uint8)
    static[: H // 2] = 5
    person = np.zeros((H, W), np.uint8)
    cx0 = int((0.15 + 0.015 * t) * W) % W
    person[H // 3 : H // 3 + H // 4, cx0 : cx0 + W // 10] = 1
    pz = 4.0
    depth[person > 0] = pz
    xl = (cx0 - cfg.camera_cx) / cfg.camera_fx * pz
    kpts = np.array(
        [[xl, -0.9, pz], [xl + 0.5, -0.9, pz], [xl, 0.9, pz], [xl + 0.5, 0.9, pz]],
        np.float32,
    )
    masks = [
        mask_cls(track_id=65535, label="static", mask=static),
        mask_cls(track_id=7, label="Person", mask=person, kpts_current=kpts,
                 kpts_previous=kpts - np.array([0.1, 0, 0], np.float32)),
    ]
    pos = np.array([0.02 * t, 0.0, 0.2 * t], np.float32)
    quat = np.array([1.0, 0, 0, 0], np.float32)
    return depth, masks, pos, quat


def synth_vkitti2_frame(cfg, t, mask_cls=MaskKpts, car_h_div=6, car_w_div=8, kpts=True):
    """VKITTI2-like frame: ground, buildings and a moving tracked car.
    ``kpts=False`` withholds the car's keypoints (a frame on which the
    tracker lost them): the object layer then coasts or rematches."""
    H, W = cfg.height, cfg.width
    rng = np.random.RandomState(t)
    v = np.arange(H, dtype=np.float32)[:, None]
    depth = np.full((H, W), 25.0, np.float32)
    ground = cfg.fy * 1.6 / np.maximum(v - cfg.cy, 1e-3)
    depth = np.minimum(depth, np.where(v > cfg.cy, ground, depth))
    depth += rng.randn(H, W).astype(np.float32) * 0.05
    static = np.where(v > cfg.cy, 6, 5).astype(np.uint8) * np.ones((1, W), np.uint8)
    car = np.zeros((H, W), np.uint8)
    cx0 = int((0.2 + 0.02 * t) * W) % W
    car[H // 2 : H // 2 + H // car_h_div, cx0 : cx0 + W // car_w_div] = 1
    car_z = 12.0
    depth[car > 0] = car_z
    xl = (cx0 - cfg.cx) / cfg.fx * car_z
    kc = np.array(
        [[xl, 0, car_z], [xl + 2, 0, car_z], [xl, -1.5, car_z],
         [xl + 2, -1.5, car_z], [xl, 0, car_z + 4], [xl + 2, 0, car_z + 4]],
        np.float32,
    )
    kp = kc - np.array([0.02 * W / cfg.fx * car_z, 0, 0], np.float32)
    masks = [
        mask_cls(track_id=65535, label="static", mask=static),
        mask_cls(track_id=3, label="Car", mask=car, kpts_current=kc if kpts else None,
                 kpts_previous=kp if kpts else None),
    ]
    pos = np.array([0.0, 0.0, 0.35 * t], np.float32)
    quat = np.array([1.0, 0, 0, 0], np.float32)
    return depth, masks, pos, quat


def synth_template_frame(cfg, t, mask_cls=MaskKpts):
    """The VKITTI2 frame with the car a fifth of the image high: 6,600
    points over 1.44 x 1.22 m, inside the template-birth window (more than
    1,500 points, both extents at least 1 m), so the template stage sweeps
    and births on frame 0.  ``bench.py``'s own template cell uses
    ``car_h_div=8``: that car is 0.74 m high, never eligible, and the JAX
    cell never swept."""
    return synth_vkitti2_frame(cfg, t, mask_cls, car_h_div=5, car_w_div=14)


def synth_hostile_frame(cfg, t, mask_cls=MaskKpts, car_depth_offset=0.0):
    """The stress scene: 20 moving tracked cars at staggered depths, a dense
    near-field wall at 3.5 m (a heavy birth front), buildings and ground, ego
    yaw and forward motion; sized so that the VKITTI2 preset's caps nearly
    bind (the move cap does).

    The cars' depths are the exact constants 8, 10, ..., 20 m, which are
    voxel boundaries of a 0.2 m grid.  ``car_depth_offset`` moves them off
    (for comparisons between backends whose floats differ in the last bit
    on such a boundary); 0 is the bench's scene."""
    H, W = cfg.height, cfg.width
    rng = np.random.RandomState(t)
    v = np.arange(H, dtype=np.float32)[:, None]
    depth = np.full((H, W), 28.0, np.float32)
    ground = cfg.fy * 1.6 / np.maximum(v - cfg.cy, 1e-3)
    depth = np.minimum(depth, np.where(v > cfg.cy, ground, depth))
    depth += rng.randn(H, W).astype(np.float32) * 0.05
    static = np.where(v > cfg.cy, 6, 5).astype(np.uint8) * np.ones((1, W), np.uint8)

    # dense near-field structure: a wall strip at 3.5 m sweeping with t
    w0 = int((0.05 + 0.01 * t) * W) % (W // 2)
    depth[: H // 3, w0 : w0 + W // 5] = 3.5 + rng.randn(H // 3, W // 5) * 0.02

    masks = [mask_cls(track_id=65535, label="static", mask=static)]
    for i in range(20):
        car = np.zeros((H, W), np.uint8)
        col = (i % 5) / 5.0
        row = (i // 5) / 4.0
        cz = 8.0 + 2.0 * (i % 7) + car_depth_offset
        cw, ch = W // 14, H // 10
        cx0 = int((col + 0.01 * t * (1 + i % 3)) * W) % (W - cw)
        cy0 = int(H // 2 + row * H // 3) % (H - ch)
        car[cy0 : cy0 + ch, cx0 : cx0 + cw] = 1
        depth[car > 0] = cz
        xl = (cx0 - cfg.cx) / cfg.fx * cz
        yt = (cy0 - cfg.cy) / cfg.fy * cz
        kpts = np.array(
            [[xl, yt, cz], [xl + 1.8, yt, cz], [xl, yt + 1.2, cz],
             [xl + 1.8, yt + 1.2, cz], [xl + 0.9, yt + 0.6, cz],
             [xl, yt, cz + 3.5]],
            np.float32,
        )
        dx = 0.01 * W / cfg.fx * cz * (1 + i % 3)
        masks.append(
            mask_cls(track_id=10 + i, label="Car", mask=car, kpts_current=kpts,
                     kpts_previous=kpts - np.array([dx, 0, 0], np.float32))
        )

    yaw = 0.008 * t  # about 0.46 degrees of ego rotation a frame
    quat = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0], np.float32)
    pos = np.array([0.05 * t, 0.0, 0.3 * t], np.float32)
    return depth, masks, pos, quat


def synth_coda_frame(cfg, t, mask_cls=MaskKpts):
    """A campus-robot frame for the coda preset (960 x 540, depth range
    10 m): ground 1.2 m under the camera, a wall at 7.5 m, and one tracked
    pedestrian-sized mover at 5 m with six matched feature points, walking
    right; the robot drives forward 0.1 m a frame.  The preset's movement
    mode is "always moving": the mover's particles move from its second
    frame on."""
    H, W = cfg.height, cfg.width
    rng = np.random.RandomState(t)
    v = np.arange(H, dtype=np.float32)[:, None]
    depth = np.full((H, W), 7.5, np.float32)
    ground = cfg.fy * 1.2 / np.maximum(v - cfg.cy, 1e-3)
    depth = np.minimum(depth, np.where(v > cfg.cy, ground, depth))
    depth += rng.randn(H, W).astype(np.float32) * 0.02
    static = np.where(v > cfg.cy, 6, 5).astype(np.uint8) * np.ones((1, W), np.uint8)
    car = np.zeros((H, W), np.uint8)
    cx0 = int((0.25 + 0.015 * t) * W) % (W - W // 8)
    car[H // 3 : H // 3 + H // 4, cx0 : cx0 + W // 8] = 1
    cz = 5.03
    depth[car > 0] = cz
    xl = (cx0 - cfg.cx) / cfg.fx * cz
    yt = (H // 3 - cfg.cy) / cfg.fy * cz
    kpts = np.array(
        [[xl, yt, cz], [xl + 1.0, yt, cz], [xl, yt + 1.1, cz],
         [xl + 1.0, yt + 1.1, cz], [xl + 0.5, yt + 0.5, cz], [xl, yt, cz + 0.8]],
        np.float32,
    )
    dx = 0.015 * W / cfg.fx * cz
    masks = [
        mask_cls(track_id=65535, label="static", mask=static),
        mask_cls(track_id=5, label="Car", mask=car, kpts_current=kpts,
                 kpts_previous=kpts - np.array([dx, 0, 0], np.float32)),
    ]
    pos = np.array([0.0, 0.0, 0.1 * t], np.float32)
    quat = np.array([1.0, 0, 0, 0], np.float32)
    return depth, masks, pos, quat
