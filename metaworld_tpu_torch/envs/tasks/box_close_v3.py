"""box-close-v3: pick up the lid and place it on the box (batched
counterpart of the JAX package's `envs/tasks/box_close_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, add_const, mul_const, norm
from metaworld_tpu_torch.envs.scene_builder import FreeObj, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.rewards import utils as reward_utils

_IDEAL_QUAT = (0.707, 0.0, 0.0, 0.707)


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.25


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    # the lid spawns in mid-air at COM 0.095 and falls to rest in the
    # first steps; the reset observation reads the pre-fall height
    target = rand[:, 3:6]
    return dict(
        obj_pos=common.pad_obj_pos(common.vec3(rand[:, 0], rand[:, 1], 0.095)),
        obj_init_pos=common.pad_obj_pos(common.vec3(rand[:, 0], rand[:, 1], 0.02)),
        target=target,
        fixture_pos=common.vec3(target[:, 0], target[:, 1], 0.0),
    )


def _obs(spec: TaskSpec, state):
    """The lid plate's COM (the handle knob is grasp geometry only)."""
    return state.sim.obj_pos, common.live_quat(spec, state)


def _reward(spec: TaskSpec, state, obs, action):
    reward_grab = torch.clamp(
        (torch.clamp(action[:, 3], -1.0, 1.0) + 1.0) / 2.0, 0.0, 1.0)
    quat_err = norm(add_const(obs[:, 7:11], tuple(-q for q in _IDEAL_QUAT)))
    reward_quat = torch.clamp(1.0 - quat_err / 0.2, min=0.0)

    hand = obs[:, :3]
    lid = add_const(obs[:, 4:7], (0.0, 0.0, 0.02))
    threshold = 0.02
    radius = norm(hand[:, :2] - lid[:, :2])
    floor = torch.where(
        radius <= threshold,
        0.0,
        0.04 * torch.log(torch.clamp(radius - threshold, min=1e-12)) + 0.4,
    )
    above_floor = torch.where(
        hand[:, 2] >= floor,
        1.0,
        reward_utils.tolerance(
            floor - hand[:, 2], bounds=(0.0, 0.01),
            margin=torch.clamp(floor / 2.0, min=1e-6), sigmoid="long_tail",
        ),
    )
    in_place = reward_utils.tolerance(
        norm(hand - lid), bounds=(0, 0.02), margin=0.5, sigmoid="long_tail",
    )
    ready_to_lift = reward_utils.hamacher_product(above_floor, in_place)
    a, b = 0.2, 0.8
    pos_error = state.target - lid
    lifted = a * (lid[:, 2] > 0.04) + b * reward_utils.tolerance(
        norm(mul_const(pos_error, (1.0, 1.0, 3.0))), bounds=(0, 0.05),
        margin=0.25, sigmoid="long_tail",
    )
    reward = (2.0 * reward_utils.hamacher_product(reward_grab, ready_to_lift)
              + 8.0 * lifted)
    success = norm(obs[:, 4:7] - state.target) < 0.08
    reward = torch.where(success, 10.0, reward)
    reward = reward * reward_quat
    return common.eval_out(
        reward=reward,
        success=success,
        near_object=ready_to_lift,
        grasp_success=reward_grab >= 0.5,
        grasp_reward=reward_grab,
        in_place_reward=lifted,
        obj_to_target=0.0,
    )


@registry.register("box-close-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.04, half_h=0.015, graspable=True,
                      grasp_halfwidth=0.018, grasp_off=(0.0, 0.0, 0.075),
                      droop=0.10)],
        # the open box the lid is placed on
        boxes=[StaticBox(pos=(0.0, 0.0, 0.02), size=(0.09, 0.09, 0.02),
                         rel_fixture=True)],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="box-close-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([-0.05, 0.5, 0.02, -0.1, 0.7, 0.133]),
        rand_high=np.array([0.05, 0.55, 0.02, 0.1, 0.8, 0.133]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([-0.1, 0.7, 0.133]),
        goal_high=np.array([0.1, 0.8, 0.133]),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=_obs,
        obj_quat0=np.array([[0.70710678, 0.0, 0.0, 0.70710678],
                            [1.0, 0.0, 0.0, 0.0]]),
        quat_style=("wxyz", "wxyz"),
        n_obs_obj=1,
    )
