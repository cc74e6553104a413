# Frozen copy of metaworld_tpu_torch/envs/tasks/bin_picking_v3.py at commit 3742bce; imports renamed.
"""bin-picking-v3: move the cube from bin A to bin B (batched counterpart
of the JAX package's `envs/tasks/bin_picking_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec, gripper_caging_reward, norm
from mwbench.reference.envs.scene_builder import FreeObj, build_scene
from mwbench.reference.envs.tasks import common
from mwbench.reference.rewards import utils as reward_utils

_OBJ_LOW = (-0.21, 0.65, 0.02)
_OBJ_HIGH = (-0.03, 0.75, 0.02)
_GOAL_LOW = (0.1199, 0.699, -0.001)
_GOAL_HIGH = (0.1201, 0.701, 0.001)


def _reset(spec: TaskSpec, rand, gen):
    obj = common.vec3(rand[:, 0], rand[:, 1], 0.03)
    target = common.const_rows(rand, (0.12, 0.7, 0.0))
    # the in_place margin latches at reset (the object is static until
    # the first step)
    return dict(
        obj_pos=common.pad_obj_pos(obj),
        obj_init_pos=common.pad_obj_pos(obj),
        target=target,
        extras=common.extras_vec(norm(obj - target)),
    )


def _funnel(radius, threshold):
    return torch.where(
        radius > threshold,
        0.02 * torch.log(torch.clamp(radius - threshold, min=1e-12)) + 0.2,
        0.0,
    )


def _reward(spec: TaskSpec, state, obs, action):
    hand = obs[:, :3]
    obj = obs[:, 4:7]
    target_to_obj = norm(obj - state.target)
    in_place = reward_utils.tolerance(
        target_to_obj, bounds=(0, 0.05), margin=state.extras[:, 0],
        sigmoid="long_tail",
    )
    threshold = 0.03
    r1 = norm(hand[:, :2] - state.obj_init_pos[:, 0, :2])
    r2 = norm(hand[:, :2] - state.target[:, :2])
    floor = torch.minimum(_funnel(r1, threshold), _funnel(r2, threshold))
    above_floor = torch.where(
        hand[:, 2] >= floor,
        1.0,
        reward_utils.tolerance(
            torch.clamp(floor - hand[:, 2], min=0.0),
            bounds=(0.0, 0.01), margin=0.05, sigmoid="long_tail",
        ),
    )
    object_grasped = gripper_caging_reward(
        spec, state, action, obj,
        obj_radius=0.015, pad_success_thresh=0.05,
        object_reach_radius=0.01, xz_thresh=0.01,
        desired_gripper_effort=0.7, high_density=True,
    )
    reward = reward_utils.hamacher_product(object_grasped, in_place)
    near_object = norm(obj - hand) < 0.04
    pinched_without_obj = obs[:, 3] < 0.43
    lifted = obj[:, 2] - 0.02 > state.obj_init_pos[:, 0, 2]
    grasp_success = near_object & lifted & ~pinched_without_obj
    reward = torch.where(
        grasp_success,
        reward + 1.0 + 5.0 * reward_utils.hamacher_product(above_floor, in_place),
        reward,
    )
    reward = torch.where(target_to_obj < 0.05, 10.0, reward)
    return common.eval_out(
        reward=reward,
        success=target_to_obj <= 0.05,
        near_object=near_object,
        grasp_success=grasp_success,
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=target_to_obj,
    )


@registry.register("bin-picking-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        # the cube rests on the bin floor 1 cm above the table
        objs=[FreeObj(radius=0.02, half_h=0.03, graspable=True, grasp_halfwidth=0.022,
                      droop=0.02)],
        mocap_low=(-0.5, 0.40, 0.07),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="bin-picking-v3",
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
