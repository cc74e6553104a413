"""basketball-v3: dunk the ball through the hoop (batched counterpart of
the JAX package's `envs/tasks/basketball_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import (
    TaskSpec, add_const, gripper_caging_reward, mul_const, norm)
from metaworld_tpu_torch.envs.scene_builder import FreeObj, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.rewards import utils as reward_utils

_OBJ_LOW = (-0.1, 0.6, 0.0299)
_OBJ_HIGH = (0.1, 0.7, 0.0301)
_GOAL_LOW = (-0.1, 0.85, 0.0)
_GOAL_HIGH = (0.1, 0.9, 0.0)
_SITE_OFFSET = (0.0, -0.083, 0.25)  # goal site relative to the basket body
# the reference's goal space is the site-offset bounds
_GOAL_SPACE_LOW = (-0.1, 0.767, 0.2499)
_GOAL_SPACE_HIGH = (0.1, 0.8170001, 0.2501)
_SCALE = (1.0, 1.0, 2.0)


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.15


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    obj = common.vec3(rand[:, 0], rand[:, 1], 0.03)
    basket = rand[:, 3:6]
    return dict(
        obj_pos=common.pad_obj_pos(obj),
        obj_init_pos=common.pad_obj_pos(obj),
        target=add_const(basket, _SITE_OFFSET),
        fixture_pos=basket,
    )


def _reward(spec: TaskSpec, state, obs, action):
    target_radius = 0.08
    obj = obs[:, 4:7]
    obj_init = state.obj_init_pos[:, 0]
    target = common.vec3(state.target[:, 0], state.target[:, 1], 0.3)
    target_to_obj = norm(mul_const(obj - target, _SCALE))
    target_to_obj_init = norm(mul_const(obj_init - target, _SCALE))
    in_place = reward_utils.tolerance(
        target_to_obj, bounds=(0, target_radius), margin=target_to_obj_init,
        sigmoid="long_tail",
    )
    tcp_opened = obs[:, 3]
    tcp_to_obj = norm(obj - state.sim.hand)
    object_grasped = gripper_caging_reward(
        spec, state, action, obj,
        object_reach_radius=0.01, obj_radius=0.025,
        pad_success_thresh=0.06, xz_thresh=0.005, high_density=True,
    )
    holding = (tcp_to_obj < 0.035) & (tcp_opened > 0) & (
        obj[:, 2] - 0.01 > obj_init[:, 2])
    object_grasped = torch.where(holding, 1.0, object_grasped)
    reward = reward_utils.hamacher_product(object_grasped, in_place)
    reward = torch.where(holding, reward + 1.0 + 5.0 * in_place, reward)
    reward = torch.where(target_to_obj < target_radius, 10.0, reward)

    return common.eval_out(
        reward=reward,
        success=target_to_obj <= target_radius,
        near_object=tcp_to_obj <= 0.05,
        grasp_success=(tcp_opened > 0) & (obj[:, 2] - 0.03 > obj_init[:, 2]),
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=target_to_obj,
    )


@registry.register("basketball-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        # the pads pinch the ball below its equator (grasp_off z -0.006)
        objs=[FreeObj(kind=2, radius=0.025, half_h=0.03, graspable=True,
                      grasp_halfwidth=0.025, mass=0.05,
                      grasp_off=(0.0, 0.0, -0.006))],
        # the hoop's backboard and pole (ref objects/assets/basketballhoop.xml)
        boxes=[StaticBox(pos=(0.0, 0.0, 0.29), size=(0.1, 0.01, 0.07),
                         rel_fixture=True),
               StaticBox(pos=(0.0, 0.0, 0.118), size=(0.007, 0.007, 0.108),
                         rel_fixture=True)],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="basketball-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.concatenate([_OBJ_LOW, _GOAL_LOW]),
        rand_high=np.concatenate([_OBJ_HIGH, _GOAL_HIGH]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.asarray(_GOAL_SPACE_LOW),
        goal_high=np.asarray(_GOAL_SPACE_HIGH),
        reset_fn=_reset,
        reward_fn=_reward,
        n_obs_obj=1,
        quat_style=("wxyz", "wxyz"),
    )
