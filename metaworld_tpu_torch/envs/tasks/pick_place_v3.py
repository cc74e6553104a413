"""pick-place-v3: grasp the puck and carry it to a target in the air
(batched counterpart of the JAX package's `envs/tasks/pick_place_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, norm, touching_main_object, zero_y
from metaworld_tpu_torch.envs.scene_builder import FreeObj, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.physics import engine
from metaworld_tpu_torch.rewards import utils as reward_utils

_OBJ_LOW = (-0.1, 0.6, 0.02)
_OBJ_HIGH = (0.1, 0.7, 0.02)
_GOAL_LOW = (-0.1, 0.8, 0.05)
_GOAL_HIGH = (0.1, 0.9, 0.3)
_HAND_INIT = (0.0, 0.6, 0.2)
_HAND_LOW = (-0.5, 0.40, 0.05)
_HAND_HIGH = (0.5, 1.0, 0.5)


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.15


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    obj = rand[:, :3]
    obj_height = obj[:, 2]
    height_target = obj_height + 0.04
    return dict(
        obj_pos=common.pad_obj_pos(obj),
        obj_init_pos=common.pad_obj_pos(obj),
        target=rand[:, 3:6],
        extras=common.extras_vec(obj_height, height_target),
    )


def pick_place_caging(state, action, obj):
    """The task-specific caging override (ref :180-248)."""
    pad_success_margin = 0.05
    x_z_success_margin = 0.005
    obj_radius = 0.015
    tcp = state.sim.hand
    left_pad, right_pad = engine.pad_positions(state.sim)
    delta_y_left = left_pad[:, 1] - obj[:, 1]
    delta_y_right = obj[:, 1] - right_pad[:, 1]
    right_margin = torch.abs(torch.abs(obj[:, 1] - right_pad[:, 1])
                             - pad_success_margin)
    left_margin = torch.abs(torch.abs(obj[:, 1] - left_pad[:, 1])
                            - pad_success_margin)

    right_caging = reward_utils.tolerance(
        delta_y_right, bounds=(obj_radius, pad_success_margin),
        margin=right_margin, sigmoid="long_tail",
    )
    left_caging = reward_utils.tolerance(
        delta_y_left, bounds=(obj_radius, pad_success_margin),
        margin=left_margin, sigmoid="long_tail",
    )
    y_caging = reward_utils.hamacher_product(left_caging, right_caging)

    tcp_obj_xz = norm(zero_y(tcp) - zero_y(obj))
    xz_margin = (norm(zero_y(state.obj_init_pos[:, 0]) - zero_y(state.init_tcp))
                 - x_z_success_margin)
    x_z_caging = reward_utils.tolerance(
        tcp_obj_xz, bounds=(0, x_z_success_margin),
        margin=xz_margin, sigmoid="long_tail",
    )

    gripper_closed = torch.clamp(torch.clamp(action[:, -1], min=0.0), max=1.0)
    caging = reward_utils.hamacher_product(y_caging, x_z_caging)
    gripping = torch.where(caging > 0.97, gripper_closed, 0.0)
    caging_and_gripping = reward_utils.hamacher_product(caging, gripping)
    return (caging_and_gripping + caging) / 2


def _reward(spec: TaskSpec, state, obs, action):
    target_radius = 0.05
    tcp = state.sim.hand
    obj = obs[:, 4:7]
    tcp_opened = obs[:, 3]
    target = state.target

    obj_to_target = norm(obj - target)
    tcp_to_obj = norm(obj - tcp)
    in_place_margin = norm(state.obj_init_pos[:, 0] - target)
    in_place = reward_utils.tolerance(
        obj_to_target, bounds=(0, target_radius),
        margin=in_place_margin, sigmoid="long_tail",
    )
    object_grasped = pick_place_caging(state, action, obj)
    in_place_and_grasped = reward_utils.hamacher_product(object_grasped, in_place)

    lifted = obj[:, 2] - 0.01 > state.obj_init_pos[:, 0, 2]
    grasp_bonus = (tcp_to_obj < 0.02) & (tcp_opened > 0) & lifted
    reward = in_place_and_grasped + torch.where(grasp_bonus, 1.0 + 5.0 * in_place,
                                                0.0)
    reward = torch.where(obj_to_target < target_radius, 10.0, reward)

    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.07,
        near_object=tcp_to_obj <= 0.03,
        grasp_success=(
            touching_main_object(state)
            & (tcp_opened > 0)
            & (obj[:, 2] - 0.02 > state.obj_init_pos[:, 0, 2])
        ),
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=obj_to_target,
    )


@registry.register("pick-place-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.02, half_h=0.02, graspable=True, grasp_halfwidth=0.0227,
                      droop=0.03)],
        mocap_low=_HAND_LOW,
        mocap_high=_HAND_HIGH,
    )
    return TaskSpec(
        name="pick-place-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.concatenate([_OBJ_LOW, _GOAL_LOW]),
        rand_high=np.concatenate([_OBJ_HIGH, _GOAL_HIGH]),
        hand_init_pos=np.asarray(_HAND_INIT),
        goal_low=np.asarray(_GOAL_LOW),
        goal_high=np.asarray(_GOAL_HIGH),
        reset_fn=_reset,
        reward_fn=_reward,
        n_obs_obj=1,
    )
