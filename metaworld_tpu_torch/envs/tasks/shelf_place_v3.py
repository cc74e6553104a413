"""shelf-place-v3: place the block on the shelf (batched counterpart of the
JAX package's `envs/tasks/shelf_place_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import (
    TaskSpec, gripper_caging_reward, norm, touching_main_object)
from metaworld_tpu_torch.envs.scene_builder import FreeObj, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.rewards import utils as reward_utils

_OBJ_LOW = (-0.1, 0.5, 0.019)
_OBJ_HIGH = (0.1, 0.6, 0.021)
_GOAL_LOW = (-0.1, 0.8, 0.299)
_GOAL_HIGH = (0.1, 0.9, 0.301)


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.1


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    obj = common.vec3(rand[:, 0], rand[:, 1], 0.02)
    return dict(
        obj_pos=common.pad_obj_pos(obj),
        obj_init_pos=common.pad_obj_pos(obj),
        target=rand[:, 3:6],
        fixture_pos=common.vec3(rand[:, 3], rand[:, 4], rand[:, 5] - 0.3),
    )


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
        obj_to_target, bounds=(0, target_radius), margin=in_place_margin,
        sigmoid="long_tail",
    )
    object_grasped = gripper_caging_reward(
        spec, state, action, obj,
        obj_radius=0.02, pad_success_thresh=0.05,
        object_reach_radius=0.01, xz_thresh=0.01, high_density=False,
    )
    reward = reward_utils.hamacher_product(object_grasped, in_place)

    # approach-zone shaping: in_place fades under the shelf lip and is
    # zero behind the shelf
    in_zone_x = (target[:, 0] - 0.15 < obj[:, 0]) & (obj[:, 0] < target[:, 0] + 0.15)
    under = (0.0 < obj[:, 2]) & (obj[:, 2] < 0.24)
    lip = target[:, 1] - 3 * target_radius
    approach = under & in_zone_x & (lip < obj[:, 1]) & (obj[:, 1] < target[:, 1])
    z_scaling = (0.24 - obj[:, 2]) / 0.24
    y_scaling = (obj[:, 1] - lip) / (3 * target_radius)
    bound_loss = reward_utils.hamacher_product(y_scaling, z_scaling)
    in_place = torch.where(approach, torch.clamp(in_place - bound_loss, 0.0, 1.0),
                           in_place)
    behind = under & in_zone_x & (obj[:, 1] > target[:, 1])
    in_place = torch.where(behind, 0.0, in_place)

    lifted = (tcp_to_obj < 0.025) & (tcp_opened > 0) & (
        obj[:, 2] - 0.01 > state.obj_init_pos[:, 0, 2])
    reward = torch.where(lifted, reward + 1.0 + 5.0 * in_place, reward)
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


@registry.register("shelf-place-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.02, half_h=0.02, graspable=True, grasp_halfwidth=0.0227)],
        # the shelf unit, relative to the shelf body: the mid plate the
        # block lands on, the base block, the back wall and two side walls
        boxes=[
            StaticBox(pos=(0.0, -0.015, 0.24), size=(0.1, 0.095, 0.01),
                      rel_fixture=True),
            StaticBox(pos=(0.0, -0.008, 0.021), size=(0.1, 0.088, 0.021),
                      rel_fixture=True),
            StaticBox(pos=(0.0, 0.09, 0.32), size=(0.1, 0.01, 0.32),
                      rel_fixture=True),
            StaticBox(pos=(-0.11, 0.0, 0.32), size=(0.01, 0.1, 0.32),
                      rel_fixture=True),
            StaticBox(pos=(0.11, 0.0, 0.32), size=(0.01, 0.1, 0.32),
                      rel_fixture=True),
        ],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="shelf-place-v3",
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
