# Frozen copy of metaworld_tpu_torch/envs/tasks/assembly_v3.py at commit 3742bce; imports renamed.
"""assembly-v3: pick up the ring wrench and drop it over the peg (batched
counterpart of the JAX package's `envs/tasks/assembly_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import (
    TaskSpec, add_const, gripper_caging_reward, mul_const, norm)
from mwbench.reference.envs.scene_builder import FreeObj, build_scene
from mwbench.reference.envs.tasks import common
from mwbench.reference.rewards import utils as reward_utils

_HANDLE_OFF = (0.13, 0.0, 0.0)
_HANDLE_LEN = 0.02
_MINUS_IDEAL_QUAT = (-0.707, -0.0, -0.0, -0.707)


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.1


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    ring = rand[:, :3]  # ring center (RoundNut site)
    return dict(
        obj_pos=common.pad_obj_pos(ring),
        obj_init_pos=common.pad_obj_pos(ring),
        target=rand[:, 3:6],
    )


def assembly_obs(spec: TaskSpec, state):
    """The wrench reports its handle: the ring centre plus the handle offset
    rotated with the wrench."""
    pos = state.sim.obj_pos
    off = common.rotate_const(state.sim.obj_quat[:, 0], _HANDLE_OFF)
    return (torch.stack([pos[:, 0] + off, pos[:, 1]], dim=1),
            common.live_quat(spec, state))


def wrench_grab_inputs(obs):
    """(reward_quat, wrench_threshed) of the wrench tasks' rewards: the
    orientation gate and the handle point snapped to the hand's x within
    half the handle length."""
    hand = obs[:, :3]
    wrench = obs[:, 4:7]
    wx = torch.where(torch.abs(wrench[:, 0] - hand[:, 0]) < _HANDLE_LEN / 2.0,
                     hand[:, 0], wrench[:, 0])
    wrench_threshed = torch.stack([wx, wrench[:, 1], wrench[:, 2]], dim=-1)
    reward_quat = torch.clamp(
        1.0 - norm(add_const(obs[:, 7:11], _MINUS_IDEAL_QUAT)) / 0.4, min=0.0)
    return reward_quat, wrench_threshed


def _reward(spec: TaskSpec, state, obs, action):
    wrench_center = state.sim.obj_pos[:, 0]
    reward_quat, wrench_threshed = wrench_grab_inputs(obs)
    reward_grab = gripper_caging_reward(
        spec, state, action, wrench_threshed,
        object_reach_radius=0.01, obj_radius=0.015,
        pad_success_thresh=0.02, xz_thresh=0.01, medium_density=True,
    )
    # placement funnel (ref :176-203)
    pos_error = state.target - wrench_center
    radius = norm(pos_error[:, :2])
    aligned = radius < 0.02
    hooked = pos_error[:, 2] > 0.0
    success = aligned & hooked
    threshold_r = torch.where(success, 0.02, 0.01)
    target_height = torch.where(
        radius > threshold_r,
        0.02 * torch.log(torch.clamp(radius - threshold_r, min=1e-12)) + 0.2,
        0.0,
    )
    pos_error = torch.stack(
        [pos_error[:, 0], pos_error[:, 1], target_height - wrench_center[:, 2]],
        dim=-1)
    a, b = 0.1, 0.9
    lifted = (wrench_center[:, 2] > 0.02) | (radius < threshold_r)
    reward_in_place = a * lifted + b * reward_utils.tolerance(
        norm(mul_const(pos_error, (1.0, 1.0, 3.0))), bounds=(0, 0.02),
        margin=0.4, sigmoid="long_tail",
    )
    reward = (2.0 * reward_grab + 6.0 * reward_in_place) * reward_quat
    reward = torch.where(success, 10.0, reward)
    return common.eval_out(
        reward=reward,
        success=success,
        near_object=reward_quat,
        grasp_success=reward_grab >= 0.5,
        grasp_reward=reward_grab,
        in_place_reward=reward_in_place,
        obj_to_target=0.0,
    )


@registry.register("assembly-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.04, half_h=0.02, graspable=True,
                      grasp_halfwidth=0.015, grasp_off=(0.13, 0.0, 0.0),
                      droop=0.03)],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="assembly-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([0.0, 0.6, 0.02, -0.1, 0.75, 0.1]),
        rand_high=np.array([0.0, 0.6, 0.02, 0.1, 0.85, 0.1]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([-0.1, 0.75, 0.1]),
        goal_high=np.array([0.1, 0.85, 0.1]),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=assembly_obs,
        obj_quat0=np.array([[0.70710678, 0.0, 0.0, 0.70710678],
                            [1.0, 0.0, 0.0, 0.0]]),
        quat_style=("wxyz", "wxyz"),
        n_obs_obj=1,
    )
