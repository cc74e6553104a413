# Frozen copy of metaworld_tpu_torch/envs/tasks/coffee_pull_v3.py at commit 3742bce; imports renamed.
"""coffee-pull-v3: pull the mug out from under the coffee machine (batched
counterpart of the JAX package's `envs/tasks/coffee_pull_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import (
    TaskSpec, add_const, gripper_caging_reward, mul_const, norm,
    touching_main_object)
from mwbench.reference.envs.scene_builder import FreeObj, StaticBox, build_scene
from mwbench.reference.envs.tasks import common
from mwbench.reference.rewards import utils as reward_utils

_SCALE = (2.0, 2.0, 1.0)


def coffee_mug_scene():
    return build_scene(
        # physics tracks the mug's COM (half_h 0.035); the task's
        # obj_report_off moves the observation to the mug's bottom frame.
        # A tapered mug only holds in a centred pinch (grasp_x_tol).
        objs=[FreeObj(radius=0.035, half_h=0.035, graspable=True,
                      grasp_halfwidth=0.033, mass=0.15, grasp_x_tol=0.006)],
        boxes=[StaticBox(pos=(0.0, 0.05, 0.15), size=(0.08, 0.08, 0.15),
                         rel_fixture=True)],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )


def make_coffee_reward(success_thresh=0.07):
    def _reward(spec: TaskSpec, state, obs, action):
        obj = obs[:, 4:7]
        target = state.target
        target_to_obj = norm(mul_const(obj - target, _SCALE))
        target_to_obj_init = norm(mul_const(state.obj_init_pos[:, 0] - target,
                                            _SCALE))
        in_place = reward_utils.tolerance(
            target_to_obj, bounds=(0, 0.05), margin=target_to_obj_init,
            sigmoid="long_tail",
        )
        tcp_opened = obs[:, 3]
        tcp_to_obj = norm(obj - state.sim.hand)
        object_grasped = gripper_caging_reward(
            spec, state, action, obj,
            object_reach_radius=0.04, obj_radius=0.02,
            pad_success_thresh=0.05, xz_thresh=0.05,
            desired_gripper_effort=0.7, medium_density=True,
        )
        reward = reward_utils.hamacher_product(object_grasped, in_place)
        near = (tcp_to_obj < 0.04) & (tcp_opened > 0)
        reward = torch.where(near, reward + 1.0 + 5.0 * in_place, reward)
        reward = torch.where(target_to_obj < 0.05, 10.0, reward)
        obj_to_target_plain = norm(obj - target)
        return common.eval_out(
            reward=reward,
            success=obj_to_target_plain <= success_thresh,
            near_object=tcp_to_obj <= 0.03,
            grasp_success=touching_main_object(state) & (tcp_opened > 0),
            grasp_reward=object_grasped,
            in_place_reward=in_place,
            obj_to_target=obj_to_target_plain,
        )
    return _reward


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.15


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    mug = common.vec3(rand[:, 0], rand[:, 1], 0.0)
    return dict(
        obj_pos=common.pad_obj_pos(add_const(mug, (0.0, 0.0, 0.035))),
        obj_init_pos=common.pad_obj_pos(mug),
        target=rand[:, 3:6],
        fixture_pos=add_const(mug, (0.0, 0.22, 0.0)),
    )


@registry.register("coffee-pull-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="coffee-pull-v3",
        task_id=task_id,
        scene=coffee_mug_scene(),
        rand_low=np.array([-0.05, 0.7, -0.001, -0.1, 0.55, -0.001]),
        rand_high=np.array([0.05, 0.75, 0.001, 0.1, 0.65, 0.001]),
        hand_init_pos=np.array([0.0, 0.4, 0.2]),
        goal_low=np.array([-0.1, 0.55, -0.001]),
        goal_high=np.array([0.1, 0.65, 0.001]),
        obj_report_off=np.array([[0.0, 0.0, -0.035], [0.0, 0.0, 0.0]],
                                np.float32),
        reset_fn=_reset,
        reward_fn=make_coffee_reward(),
        n_obs_obj=1,
    )
