"""disassemble-v3: lift the ring wrench off the peg (batched counterpart of
the JAX package's `envs/tasks/disassemble_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import (
    TaskSpec, add_const, gripper_caging_reward, norm)
from metaworld_tpu_torch.envs.scene_builder import FreeObj, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.envs.tasks.assembly_v3 import assembly_obs, wrench_grab_inputs
from metaworld_tpu_torch.rewards import utils as reward_utils


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.1


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    ring = rand[:, :3]
    return dict(
        obj_pos=common.pad_obj_pos(ring),
        obj_init_pos=common.pad_obj_pos(ring),
        target=add_const(ring, (0.0, 0.0, 0.15)),
    )


def _reward(spec: TaskSpec, state, obs, action):
    wrench_center = state.sim.obj_pos[:, 0]
    reward_quat, wrench_threshed = wrench_grab_inputs(obs)
    reward_grab = gripper_caging_reward(
        spec, state, action, wrench_threshed,
        object_reach_radius=0.01, obj_radius=0.015,
        pad_success_thresh=0.02, xz_thresh=0.01, high_density=True,
    )
    pos_error = add_const(state.target, (0.0, 0.0, 0.1)) - wrench_center
    a, b = 0.1, 0.9
    lifted = wrench_center[:, 2] > 0.02
    reward_in_place = a * lifted + b * reward_utils.tolerance(
        norm(pos_error), bounds=(0, 0.02), margin=0.2, sigmoid="long_tail",
    )
    reward = (2.0 * reward_grab + 6.0 * reward_in_place) * reward_quat
    success = obs[:, 6] > state.target[:, 2]
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


@registry.register("disassemble-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.04, half_h=0.025, graspable=True,
                      grasp_halfwidth=0.015, grasp_off=(0.13, 0.0, 0.0))],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="disassemble-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([0.0, 0.6, 0.025, -0.1, 0.6, 0.1699]),
        rand_high=np.array([0.1, 0.75, 0.02501, 0.1, 0.75, 0.1701]),
        hand_init_pos=np.array([0.0, 0.4, 0.2]),
        goal_low=np.array([-0.1, 0.6, 0.1699]),
        goal_high=np.array([0.1, 0.75, 0.1701]),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=assembly_obs,
        obj_quat0=np.array([[0.70710678, 0.0, 0.0, 0.70710678],
                            [1.0, 0.0, 0.0, 0.0]]),
        quat_style=("wxyz", "wxyz"),
        n_obs_obj=1,
    )
