# Frozen copy of metaworld_tpu_torch/envs/tasks/push_wall_v3.py at commit 3742bce; imports renamed.
"""push-wall-v3: push the puck to the goal around a wall (batched
counterpart of the JAX package's `envs/tasks/push_wall_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import (
    TaskSpec, gripper_caging_reward, mul_const, norm, touching_main_object)
from mwbench.reference.envs.scene_builder import FreeObj, StaticBox, build_scene
from mwbench.reference.envs.tasks import common
from mwbench.reference.rewards import utils as reward_utils

_OBJ_LOW = (-0.05, 0.6, 0.015)
_OBJ_HIGH = (0.05, 0.65, 0.015)
_GOAL_LOW = (-0.05, 0.85, 0.01)
_GOAL_HIGH = (0.05, 0.9, 0.02)
_SCALING = (3.0, 1.0, 1.0)


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.15


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    obj = common.vec3(rand[:, 0], rand[:, 1], 0.02)
    return dict(
        obj_pos=common.pad_obj_pos(obj),
        obj_init_pos=common.pad_obj_pos(obj),
        target=common.vec3(rand[:, 3], rand[:, 4], 0.02),
    )


def _reward(spec: TaskSpec, state, obs, action):
    target_radius = 0.05
    tcp = state.sim.hand
    obj = obs[:, 4:7]
    tcp_opened = obs[:, 3]
    # the route's midpoint beside the wall, at the object's height
    midpoint = common.vec3(-0.05, 0.77, obj[:, 2])
    target = state.target

    tcp_to_obj = norm(obj - tcp)
    obj_to_mid = norm(mul_const(obj - midpoint, _SCALING))
    obj_to_mid_init = norm(mul_const(state.obj_init_pos[:, 0] - midpoint, _SCALING))
    obj_to_target = norm(obj - target)
    obj_to_target_init = norm(state.obj_init_pos[:, 0] - target)

    in_place_p1 = reward_utils.tolerance(
        obj_to_mid, bounds=(0, target_radius), margin=obj_to_mid_init,
        sigmoid="long_tail",
    )
    in_place_p2 = reward_utils.tolerance(
        obj_to_target, bounds=(0, target_radius), margin=obj_to_target_init,
        sigmoid="long_tail",
    )
    object_grasped = gripper_caging_reward(
        spec, state, action, obj,
        object_reach_radius=0.01, obj_radius=0.015,
        pad_success_thresh=0.05, xz_thresh=0.005, high_density=True,
    )
    reward = 2.0 * object_grasped
    near = (tcp_to_obj < 0.02) & (tcp_opened > 0)
    reward = torch.where(near, 2.0 * object_grasped + 1.0 + 4.0 * in_place_p1,
                         reward)
    reward = torch.where(
        near & (obj[:, 1] > 0.75),
        2.0 * object_grasped + 1.0 + 4.0 + 3.0 * in_place_p2,
        reward,
    )
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
        in_place_reward=in_place_p2,
        obj_to_target=obj_to_target,
    )


@registry.register("push-wall-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.02, half_h=0.02, graspable=True, grasp_halfwidth=0.0227)],
        boxes=[StaticBox(pos=(0.1, 0.75, 0.06), size=(0.12, 0.01, 0.06))],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="push-wall-v3",
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
    )
