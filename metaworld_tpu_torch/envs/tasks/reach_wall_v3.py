"""reach-wall-v3: reach the target over a wall (batched counterpart of the
JAX package's `envs/tasks/reach_wall_v3.py`)."""

from __future__ import annotations

import numpy as np

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, norm
from metaworld_tpu_torch.envs.scene_builder import FreeObj, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.rewards import utils as reward_utils

_OBJ_LOW = (-0.05, 0.6, 0.015)
_OBJ_HIGH = (0.05, 0.65, 0.015)
_GOAL_LOW = (-0.05, 0.85, 0.05)
_GOAL_HIGH = (0.05, 0.9, 0.3)


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.15


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    obj = common.vec3(rand[:, 0], rand[:, 1], 0.02)
    return dict(
        obj_pos=common.pad_obj_pos(obj),
        obj_init_pos=common.pad_obj_pos(obj),
        target=rand[:, 3:6],
    )


def _reward(spec: TaskSpec, state, obs, action):
    tcp = state.sim.hand
    target = state.target
    tcp_to_target = norm(tcp - target)
    in_place_margin = norm(state.hand_init - target)
    in_place = reward_utils.tolerance(
        tcp_to_target, bounds=(0, 0.05), margin=in_place_margin,
        sigmoid="long_tail",
    )
    return common.eval_out(
        reward=10.0 * in_place,
        success=tcp_to_target <= 0.05,
        near_object=0.0,
        grasp_success=0.0,
        grasp_reward=0.0,
        in_place_reward=in_place,
        obj_to_target=tcp_to_target,
    )


@registry.register("reach-wall-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.02, half_h=0.02, graspable=True, grasp_halfwidth=0.0227)],
        boxes=[StaticBox(pos=(0.1, 0.75, 0.06), size=(0.12, 0.01, 0.06))],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="reach-wall-v3",
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
