"""plate-slide-v3: slide the puck forward into the goal cabinet (batched
counterpart of the JAX package's `envs/tasks/plate_slide_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, norm
from metaworld_tpu_torch.envs.scene_builder import FreeObj, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.rewards import utils as reward_utils


def _cabinet_boxes(sideways: bool):
    """The goal cabinet's collision: back wall, two side walls, the top
    sheet and the front top lip, which fences the puck but not the hand.
    `sideways` yaws the cabinet by +90 degrees (local (x, y) -> world
    (-y, x)); centers are relative to the fixture."""
    local = [
        ((0.0, 0.082, 0.0964), (0.11, 0.006, 0.1035)),     # back wall
        ((0.105, 0.0, 0.0882), (0.006, 0.091, 0.1068)),    # side
        ((-0.105, 0.0, 0.0882), (0.006, 0.091, 0.1068)),   # side
        ((0.0, -0.014, 0.177), (0.105, 0.057, 0.004)),     # top sheet
        ((0.0, -0.0685, 0.174), (0.105, 0.01, 0.012), False),  # front lip
    ]
    out = []
    for (cx, cy, cz), (hx, hy, hz), *bh in local:
        if sideways:
            cx, cy, hx, hy = -cy, cx, hy, hx
        out.append(StaticBox(pos=(cx, cy, cz), size=(hx, hy, hz),
                             rel_fixture=True,
                             blocks_hand=(bh[0] if bh else True)))
    return out


def make_puck_scene(sideways: bool = False):
    """The puck, a box on two limited slide joints (world x in [-0.2, 0.2],
    y in [0.6, 0.9]), and the cabinet."""
    return build_scene(
        objs=[FreeObj(radius=0.05, half_h=0.015, graspable=False, mass=0.3,
                      xy_range=(-0.2, 0.6, 0.2, 0.9))],
        boxes=_cabinet_boxes(sideways),
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )


def make_puck_reset(puck_start, cabinet=None):
    """`cabinet`: None -> the cabinet follows the goal (plate-slide); the
    side and back variants keep it at the constant `cabinet`."""

    def _reset(spec: TaskSpec, rand, gen):
        target = rand[:, 3:6]
        return dict(
            obj_pos=common.pad_obj_pos(common.const_rows(rand, puck_start)),
            obj_init_pos=common.pad_obj_pos(rand[:, :3]),
            target=target,
            fixture_pos=(target if cabinet is None
                         else common.const_rows(rand, cabinet)),
        )
    return _reset


def _reward(spec: TaskSpec, state, obs, action):
    target_radius = 0.05
    tcp = state.sim.hand
    obj = obs[:, 4:7]
    target = state.target
    obj_to_target = norm(obj - target)
    in_place_margin = norm(state.obj_init_pos[:, 0] - target)
    in_place = reward_utils.tolerance(
        obj_to_target, bounds=(0, target_radius), margin=in_place_margin,
        sigmoid="long_tail",
    )
    tcp_to_obj = norm(tcp - obj)
    grasp_margin = norm(state.init_tcp - state.obj_init_pos[:, 0])
    object_grasped = reward_utils.tolerance(
        tcp_to_obj, bounds=(0, target_radius), margin=grasp_margin,
        sigmoid="long_tail",
    )
    reward = 8.0 * reward_utils.hamacher_product(object_grasped, in_place)
    reward = torch.where(obj_to_target < target_radius, 10.0, reward)
    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.07,
        near_object=tcp_to_obj <= 0.03,
        grasp_success=1.0,
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=obj_to_target,
    )


def staged_puck_reward(spec: TaskSpec, state, obs, action):
    """The side and back variants' reward: margins less the radius, and an
    in_place stage gated on the tcp's height."""
    target_radius = 0.05
    tcp = state.sim.hand
    obj = obs[:, 4:7]
    target = state.target
    obj_to_target = norm(obj - target)
    in_place_margin = norm(state.obj_init_pos[:, 0] - target)
    in_place = reward_utils.tolerance(
        obj_to_target, bounds=(0, target_radius),
        margin=in_place_margin - target_radius, sigmoid="long_tail",
    )
    tcp_to_obj = norm(tcp - obj)
    grasp_margin = norm(state.init_tcp - state.obj_init_pos[:, 0])
    object_grasped = reward_utils.tolerance(
        tcp_to_obj, bounds=(0, target_radius),
        margin=grasp_margin - target_radius, sigmoid="long_tail",
    )
    reward = 1.5 * object_grasped
    reward = torch.where((tcp[:, 2] <= 0.03) & (tcp_to_obj < 0.07),
                         2.0 + 7.0 * in_place, reward)
    reward = torch.where(obj_to_target < target_radius, 10.0, reward)
    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.07,
        near_object=tcp_to_obj <= 0.03,
        grasp_success=1.0,
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=obj_to_target,
    )


@registry.register("plate-slide-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="plate-slide-v3",
        task_id=task_id,
        scene=make_puck_scene(),
        rand_low=np.array([0.0, 0.6, 0.0, -0.1, 0.85, 0.0]),
        rand_high=np.array([0.0, 0.6, 0.0, 0.1, 0.9, 0.0]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([-0.1, 0.85, 0.0]),
        goal_high=np.array([0.1, 0.9, 0.0]),
        reset_fn=make_puck_reset((0.0, 0.6, 0.015)),
        reward_fn=_reward,
        n_obs_obj=1,
    )
