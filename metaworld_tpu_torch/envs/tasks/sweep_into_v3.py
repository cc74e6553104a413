"""sweep-into-v3: sweep the puck into the hole in the table (batched
counterpart of the JAX package's `envs/tasks/sweep_into_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import (
    TaskSpec, gripper_caging_reward_grip, norm, touching_main_object)
from metaworld_tpu_torch.envs.scene_builder import FreeObj, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.rewards import utils as reward_utils

_OBJ_LOW = (-0.1, 0.6, 0.02)
_OBJ_HIGH = (0.1, 0.7, 0.02)
_GOAL_LOW = (-0.001, 0.8399, 0.0199)
_GOAL_HIGH = (0.001, 0.8401, 0.0201)
_HOLE = (0.0, 0.84)


def good(v):
    d = torch.stack([v[:, 0] - _HOLE[0], v[:, 1] - _HOLE[1]], dim=-1)
    return norm(d) >= 0.15


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    # the puck's COM sits 0.05 above its free-joint origin on this table,
    # and the reference's obj_init_pos keeps that stale COM height too
    obj_com = common.vec3(rand[:, 0], rand[:, 1], 0.07)
    return dict(
        obj_pos=common.pad_obj_pos(obj_com),
        obj_init_pos=common.pad_obj_pos(obj_com),
        target=common.vec3(torch.zeros_like(rand[:, 0]), _HOLE[1], 0.02),
    )


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    tcp_opened = obs[:, 3]
    target = torch.stack([state.target[:, 0], state.target[:, 1], obj[:, 2]],
                         dim=-1)
    obj_to_target = norm(obj - target)
    tcp_to_obj = norm(obj - state.sim.hand)
    in_place_margin = norm(state.obj_init_pos[:, 0] - target)
    in_place = reward_utils.tolerance(
        obj_to_target, bounds=(0, 0.05), margin=in_place_margin,
        sigmoid="long_tail",
    )
    object_grasped = gripper_caging_reward_grip(
        spec, state, action, obj, obj_radius=0.02,
        grip_margin_add=0.005, xz_margin=0.01,
    )
    in_place_and_grasped = reward_utils.hamacher_product(object_grasped, in_place)
    reward = 2.0 * object_grasped + 6.0 * in_place_and_grasped
    reward = torch.where(obj_to_target < 0.05, 10.0, reward)

    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.05,
        near_object=tcp_to_obj <= 0.03,
        grasp_success=touching_main_object(state) & (tcp_opened > 0),
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=obj_to_target,
    )


@registry.register("sweep-into-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.02, half_h=0.02, graspable=True, grasp_halfwidth=0.0227)],
        # tabletop at +0.05 with a hole at the goal and a 0.05-deep pit
        # (assets sawyer_table_with_hole.xml)
        hole_center=_HOLE,
        hole_halfsize=(0.08, 0.08),
        pit_depth=0.05,
        table_z=0.05,
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="sweep-into-v3",
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
