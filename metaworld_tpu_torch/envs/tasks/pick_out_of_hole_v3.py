"""pick-out-of-hole-v3: lift the puck out of the pit to a goal in the air
(batched counterpart of the JAX package's `envs/tasks/pick_out_of_hole_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, gripper_caging_reward, norm
from metaworld_tpu_torch.envs.scene_builder import FreeObj, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.rewards import utils as reward_utils

_OBJ_LOW = (0.0, 0.75, 0.02)
_OBJ_HIGH = (0.0, 0.75, 0.02)
_GOAL_LOW = (-0.1, 0.5, 0.15)
_GOAL_HIGH = (0.1, 0.6, 0.3)


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.15


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    obj = rand[:, :3]
    return dict(
        obj_pos=common.pad_obj_pos(obj),
        obj_init_pos=common.pad_obj_pos(obj),
        target=rand[:, 3:6],
    )


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    gripper = state.sim.hand
    obj_init = state.obj_init_pos[:, 0]
    obj_to_target = norm(obj - state.target)
    tcp_to_obj = norm(obj - gripper)
    in_place_margin = norm(obj_init - state.target)

    threshold = 0.03
    radius = norm(gripper[:, :2] - obj_init[:, :2])
    floor = torch.where(
        radius <= threshold,
        0.0,
        0.015 * torch.log(torch.clamp(radius - threshold, min=1e-12)) + 0.15,
    )
    above_floor = torch.where(
        gripper[:, 2] >= floor,
        1.0,
        reward_utils.tolerance(
            torch.clamp(floor - gripper[:, 2], min=0.0),
            bounds=(0.0, 0.01), margin=0.02, sigmoid="long_tail",
        ),
    )
    object_grasped = gripper_caging_reward(
        spec, state, action, obj,
        object_reach_radius=0.01, obj_radius=0.015,
        pad_success_thresh=0.02, xz_thresh=0.03,
        desired_gripper_effort=0.1, high_density=True,
    )
    in_place = reward_utils.tolerance(
        obj_to_target, bounds=(0, 0.02), margin=in_place_margin,
        sigmoid="long_tail",
    )
    reward = reward_utils.hamacher_product(object_grasped, in_place)
    near_object = tcp_to_obj < 0.04
    pinched_without_obj = obs[:, 3] < 0.33
    lifted = obj[:, 2] - 0.02 > obj_init[:, 2]
    grasp_success = near_object & lifted & ~pinched_without_obj
    reward = torch.where(
        grasp_success,
        reward + 1.0 + 5.0 * reward_utils.hamacher_product(in_place, above_floor),
        reward,
    )
    reward = torch.where(obj_to_target < 0.05, 10.0, reward)

    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.07,
        near_object=tcp_to_obj <= 0.03,
        grasp_success=grasp_success,
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=obj_to_target,
    )


@registry.register("pick-out-of-hole-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.02, half_h=0.02, graspable=True, grasp_halfwidth=0.0227)],
        mocap_low=(-0.5, 0.40, -0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="pick-out-of-hole-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.concatenate([_OBJ_LOW, _GOAL_LOW]),
        rand_high=np.concatenate([_OBJ_HIGH, _GOAL_HIGH]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.asarray(_GOAL_LOW),
        goal_high=np.asarray(_GOAL_HIGH),
        reset_fn=_reset,
        reward_fn=_reward,
        n_obs_obj=1,
        quat_style=("wxyz", "wxyz"),
    )
