"""soccer-v3: kick or push the ball into the goal box (batched counterpart
of the JAX package's `envs/tasks/soccer_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import (
    TaskSpec, gripper_caging_reward_grip, mul_const, norm, touching_main_object)
from metaworld_tpu_torch.envs.scene_builder import FreeObj, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.rewards import utils as reward_utils

_OBJ_LOW = (-0.1, 0.6, 0.03)
_OBJ_HIGH = (0.1, 0.7, 0.03)
_GOAL_LOW = (-0.1, 0.8, 0.0)
_GOAL_HIGH = (0.1, 0.9, 0.0)
_X_SCALING = (3.0, 1.0, 1.0)


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.15


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    obj = common.vec3(rand[:, 0], rand[:, 1], 0.03)
    target = rand[:, 3:6]
    return dict(
        obj_pos=common.pad_obj_pos(obj),
        obj_init_pos=common.pad_obj_pos(obj),
        target=target,
        fixture_pos=target,  # the goal frame follows the target
    )


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    tcp_opened = obs[:, 3]
    tcp_to_obj = norm(obj - state.sim.hand)
    target_to_obj = norm(mul_const(obj - state.target, _X_SCALING))
    # the reference's margin is against the current object position
    target_to_obj_init = norm(mul_const(obj - state.obj_init_pos[:, 0], _X_SCALING))
    in_place = reward_utils.tolerance(
        target_to_obj, bounds=(0, 0.07), margin=target_to_obj_init,
        sigmoid="long_tail",
    )
    goal_line = state.target[:, 1] - 0.1
    offside = (obj[:, 1] > goal_line) & (
        torch.abs(obj[:, 0] - state.target[:, 0]) > 0.10)
    in_place = torch.where(
        offside,
        torch.clamp(in_place - 2.0 * ((obj[:, 1] - goal_line) / (1.0 - goal_line)),
                    0.0, 1.0),
        in_place,
    )
    object_grasped = gripper_caging_reward_grip(
        spec, state, action, obj, obj_radius=0.013,
        grip_margin_add=0.01, xz_margin=0.005,
    )
    reward = 3.0 * object_grasped + 6.5 * in_place
    reward = torch.where(target_to_obj < 0.07, 10.0, reward)
    obj_to_target_plain = norm(obj - state.target)
    return common.eval_out(
        reward=reward,
        success=obj_to_target_plain <= 0.07,
        near_object=tcp_to_obj <= 0.03,
        grasp_success=(
            touching_main_object(state)
            & (tcp_opened > 0)
            & (obj[:, 2] - 0.02 > state.obj_init_pos[:, 0, 2])
        ),
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=obj_to_target_plain,
    )


@registry.register("soccer-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        # kicked or pushed, never grasped; friction 2.5 is the calibrated
        # stopping rate of the kicked ball
        objs=[FreeObj(kind=2, radius=0.026, half_h=0.026, graspable=False, friction=2.5,
                      grasp_halfwidth=0.026, mass=0.05)],
        # the goal frame (moved to the sampled goal at reset): the net's
        # back wall, which does not block the hand, two posts and the
        # front-top bar
        boxes=[
            StaticBox(pos=(0.0, 0.09, 0.05), size=(0.105, 0.01, 0.05),
                      rel_fixture=True, blocks_hand=False),
            StaticBox(pos=(-0.096, -0.012, 0.085), size=(0.008, 0.062, 0.085),
                      rel_fixture=True),
            StaticBox(pos=(0.096, -0.012, 0.085), size=(0.008, 0.062, 0.085),
                      rel_fixture=True),
            StaticBox(pos=(0.0, 0.0, 0.15), size=(0.105, 0.03, 0.025),
                      rel_fixture=True),
        ],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="soccer-v3",
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
