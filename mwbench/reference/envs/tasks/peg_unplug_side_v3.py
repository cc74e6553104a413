# Frozen copy of metaworld_tpu_torch/envs/tasks/peg_unplug_side_v3.py at commit 3742bce; imports renamed.
"""peg-unplug-side-v3: grasp the socketed plug and pull it out (+x)
(batched counterpart of the JAX package's `envs/tasks/peg_unplug_side_v3.py`).

The plug is anchored in its socket until first grasped, and the claw
catches its end cap (a hook grasp) rather than squeezing the shaft."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec, add_const, gripper_caging_reward, norm
from mwbench.reference.envs.scene_builder import FreeObj, StaticBox, build_scene
from mwbench.reference.envs.tasks import common
from mwbench.reference.rewards import utils as reward_utils


def _reset(spec: TaskSpec, rand, gen):
    box = rand[:, :3]
    plug = add_const(box, (0.044, 0.0, 0.131))
    peg_end = add_const(plug, (0.04, 0.0, 0.0))
    return dict(
        fixture_pos=box,
        obj_pos=common.pad_obj_pos(peg_end),
        obj_init_pos=common.pad_obj_pos(peg_end),
        target=add_const(plug, (0.15, 0.0, 0.0)),
    )


def _reward(spec: TaskSpec, state, obs, action):
    tcp = state.sim.hand
    obj = obs[:, 4:7]
    tcp_opened = obs[:, 3]
    target = state.target
    tcp_to_obj = norm(obj - tcp)
    obj_to_target = norm(obj - target)
    object_grasped = gripper_caging_reward(
        spec, state, action, obj,
        object_reach_radius=0.01, obj_radius=0.025,
        pad_success_thresh=0.05, xz_thresh=0.005,
        desired_gripper_effort=0.8, high_density=True,
    )
    in_place_margin = norm(state.obj_init_pos[:, 0] - target)
    in_place = reward_utils.tolerance(
        obj_to_target, bounds=(0, 0.05), margin=in_place_margin,
        sigmoid="long_tail",
    )
    grasp_success = (tcp_opened > 0.5) & (
        obj[:, 0] - state.obj_init_pos[:, 0, 0] > 0.015)
    reward = 2.0 * object_grasped
    reward = torch.where(grasp_success & (tcp_to_obj < 0.035),
                         1.0 + 2.0 * object_grasped + 5.0 * in_place, reward)
    reward = torch.where(obj_to_target <= 0.05, 10.0, reward)
    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.07,
        near_object=tcp_to_obj <= 0.03,
        grasp_success=grasp_success,
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=obj_to_target,
    )


@registry.register("peg-unplug-side-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.03, half_h=0.03, graspable=True,
                      grasp_halfwidth=0.031, anchored=True, hook_grasp=True,
                      grasp_off=(-0.025, 0.0, -0.006))],
        boxes=[StaticBox(pos=(-0.05, 0.0, 0.1), size=(0.08, 0.1, 0.1),
                         rel_fixture=True)],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="peg-unplug-side-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([-0.25, 0.6, -0.001]),
        rand_high=np.array([-0.15, 0.8, 0.001]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([-0.056, 0.6, 0.1299]),
        goal_high=np.array([0.044, 0.8, 0.1311]),
        reset_fn=_reset,
        reward_fn=_reward,
        n_obs_obj=1,
        quat_style=("wxyz", "wxyz"),
    )
