"""peg-insert-side-v3: grasp the peg and insert it sideways into the box
hole (batched counterpart of the JAX package's
`envs/tasks/peg_insert_side_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import (
    TaskSpec, add_const, gripper_caging_reward, mul_const, norm,
    touching_main_object)
from metaworld_tpu_torch.envs.scene_builder import FreeObj, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.rewards import utils as reward_utils

_HEAD_OFF = (-0.13, 0.0, -0.01)
_HEAD_INIT = (-0.1, 0.6, 0.015)
_SCALE = (1.0, 2.0, 2.0)


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.1


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    peg = common.vec3(rand[:, 0] + 0.03, rand[:, 1], 0.03)
    box = rand[:, 3:6]
    head0 = add_const(peg, _HEAD_OFF)
    peg_com = common.vec3(rand[:, 0], rand[:, 1], 0.02)
    return dict(
        obj_pos=common.pad_obj_pos(peg),
        obj_init_pos=common.pad_obj_pos(peg_com),
        target=add_const(box, (0.03, 0.0, 0.13)),
        fixture_pos=box,
        extras=common.extras_vec(head0[:, 0], head0[:, 1], head0[:, 2]),
    )


def _reward(spec: TaskSpec, state, obs, action):
    tcp = state.sim.hand
    obj = obs[:, 4:7]
    obj_head = add_const(obj, _HEAD_OFF)
    tcp_opened = obs[:, 3]
    target = state.target
    tcp_to_obj = norm(obj - tcp)
    obj_to_target = norm(mul_const(obj_head - target, _SCALE))
    head_init_to_target = torch.stack(
        [_HEAD_INIT[k] - target[:, k] for k in range(3)], dim=-1)
    in_place_margin = norm(mul_const(head_init_to_target, _SCALE))
    in_place = reward_utils.tolerance(
        obj_to_target, bounds=(0, 0.07), margin=in_place_margin,
        sigmoid="long_tail",
    )
    box = add_const(target, (-0.03, -0.0, -0.13))
    cb1 = reward_utils.rect_prism_tolerance(
        obj_head, zero=add_const(box, (0.11, 0.1, 0.01)),
        one=add_const(box, (0.15, -0.1, 0.096)))
    cb2 = reward_utils.rect_prism_tolerance(
        obj_head, zero=add_const(box, (0.11, 0.1, 0.16)),
        one=add_const(box, (0.17, -0.1, 0.19)))
    collision_boxes = reward_utils.hamacher_product(cb2, cb1)
    in_place = reward_utils.hamacher_product(in_place, collision_boxes)
    object_grasped = gripper_caging_reward(
        spec, state, action, obj,
        object_reach_radius=0.01, obj_radius=0.0075,
        pad_success_thresh=0.03, xz_thresh=0.005, high_density=True,
    )
    holding = (tcp_to_obj < 0.08) & (tcp_opened > 0) & (
        obj[:, 2] - 0.01 > state.obj_init_pos[:, 0, 2]
    )
    object_grasped = torch.where(holding, 1.0, object_grasped)
    reward = reward_utils.hamacher_product(object_grasped, in_place)
    reward = torch.where(holding, reward + 1.0 + 5.0 * in_place, reward)
    reward = torch.where(obj_to_target <= 0.07, 10.0, reward)
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


@registry.register("peg-insert-side-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.018, half_h=0.03, graspable=True,
                      grasp_halfwidth=0.015)],
        boxes=[
            StaticBox(pos=(0.0, 0.0, 0.05), size=(0.096, 0.09, 0.05),
                      rel_fixture=True),
            StaticBox(pos=(0.0, 0.0, 0.185), size=(0.098, 0.09, 0.025),
                      rel_fixture=True),
            StaticBox(pos=(0.0, 0.06, 0.13), size=(0.096, 0.03, 0.03),
                      rel_fixture=True),
            StaticBox(pos=(0.0, -0.06, 0.13), size=(0.096, 0.03, 0.03),
                      rel_fixture=True),
        ],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="peg-insert-side-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([0.0, 0.5, 0.02, -0.35, 0.4, -0.001]),
        rand_high=np.array([0.2, 0.7, 0.02, -0.25, 0.7, 0.001]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([-0.32, 0.4, 0.1289]),
        goal_high=np.array([-0.22, 0.7, 0.1311]),
        reset_fn=_reset,
        reward_fn=_reward,
        n_obs_obj=1,
    )
