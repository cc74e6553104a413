"""push-v3: push the puck to a goal on the table (batched counterpart of
the JAX package's `envs/tasks/push_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import (
    TaskSpec, gripper_caging_reward, norm, touching_main_object)
from metaworld_tpu_torch.envs.scene_builder import FreeObj, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.rewards import utils as reward_utils

_OBJ_LOW = (-0.1, 0.6, 0.02)
_OBJ_HIGH = (0.1, 0.7, 0.02)
_GOAL_LOW = (-0.1, 0.8, 0.01)
_GOAL_HIGH = (0.1, 0.9, 0.02)


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.15


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    obj = common.vec3(rand[:, 0], rand[:, 1], 0.02)
    target = common.vec3(rand[:, 3], rand[:, 4], 0.02)
    return dict(
        obj_pos=common.pad_obj_pos(obj),
        obj_init_pos=common.pad_obj_pos(obj),
        target=target,
    )


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    tcp_opened = obs[:, 3]
    tcp_to_obj = norm(obj - state.sim.hand)
    target_to_obj = norm(obj - state.target)
    target_to_obj_init = norm(state.obj_init_pos[:, 0] - state.target)

    in_place = reward_utils.tolerance(
        target_to_obj, bounds=(0, 0.05), margin=target_to_obj_init,
        sigmoid="long_tail",
    )
    object_grasped = gripper_caging_reward(
        spec, state, action, obj,
        object_reach_radius=0.01, obj_radius=0.015,
        pad_success_thresh=0.05, xz_thresh=0.005, high_density=True,
    )
    reward = 2.0 * object_grasped
    near = (tcp_to_obj < 0.02) & (tcp_opened > 0)
    reward = torch.where(near, reward + 1.0 + reward + 5.0 * in_place, reward)
    reward = torch.where(target_to_obj < 0.05, 10.0, reward)

    return common.eval_out(
        reward=reward,
        success=target_to_obj <= 0.05,
        near_object=tcp_to_obj <= 0.03,
        grasp_success=(
            touching_main_object(state)
            & (tcp_opened > 0)
            & (obj[:, 2] - 0.02 > state.obj_init_pos[:, 0, 2])
        ),
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=target_to_obj,
    )


@registry.register("push-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.02, half_h=0.02, graspable=True, grasp_halfwidth=0.0227)],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="push-v3",
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
