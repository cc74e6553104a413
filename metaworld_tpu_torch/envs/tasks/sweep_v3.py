"""sweep-v3: sweep the puck off to the right edge of the table (batched
counterpart of the JAX package's `envs/tasks/sweep_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import (
    TaskSpec, gripper_caging_reward_grip, norm, touching_main_object)
from metaworld_tpu_torch.envs.scene_builder import FreeObj, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.rewards import utils as reward_utils

_OBJ_LOW = (-0.1, 0.6, 0.02)
_OBJ_HIGH = (0.1, 0.7, 0.02)
_GOAL_LOW = (0.49, 0.6, 0.00)
_GOAL_HIGH = (0.51, 0.7, 0.02)


def _reset(spec: TaskSpec, rand, gen):
    # the block's COM spawns at 0.04 and settles to 0.02; the -0.02 report
    # offset reproduces the reference's body-frame height at both ends
    return dict(
        obj_pos=common.pad_obj_pos(common.vec3(rand[:, 0], rand[:, 1], 0.04)),
        obj_init_pos=common.pad_obj_pos(common.vec3(rand[:, 0], rand[:, 1], 0.02)),
        target=common.vec3(0.5, rand[:, 1], 0.01),
    )


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    tcp_opened = obs[:, 3]
    target = state.target
    obj_to_target = norm(obj - target)
    tcp_to_obj = norm(obj - state.sim.hand)
    in_place_margin = norm(state.obj_init_pos[:, 0] - target)
    in_place = reward_utils.tolerance(
        obj_to_target, bounds=(0, 0.05), margin=in_place_margin,
        sigmoid="long_tail",
    )
    object_grasped = gripper_caging_reward_grip(
        spec, state, action, obj, obj_radius=0.02,
        grip_margin_add=0.01, xz_margin=0.005,
    )
    in_place_and_grasped = reward_utils.hamacher_product(object_grasped, in_place)
    reward = 2.0 * object_grasped + 6.0 * in_place_and_grasped
    reward = torch.where(obj_to_target < 0.05, 10.0, reward)
    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.05,
        near_object=tcp_to_obj <= 0.03,
        grasp_success=touching_main_object(state) & (tcp_opened > 0),
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=obj_to_target,
    )


@registry.register("sweep-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.02, half_h=0.02, graspable=True, grasp_halfwidth=0.0227,
                      friction=1.0)],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="sweep-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.asarray(_OBJ_LOW),
        rand_high=np.asarray(_OBJ_HIGH),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        # the reference reports the block's bottom-face frame
        obj_report_off=np.array([[0.0, 0.0, -0.02], [0.0, 0.0, 0.0]],
                                np.float32),
        goal_low=np.asarray(_GOAL_LOW),
        goal_high=np.asarray(_GOAL_HIGH),
        reset_fn=_reset,
        reward_fn=_reward,
        n_obs_obj=1,
        quat_style=("wxyz", "wxyz"),
    )
