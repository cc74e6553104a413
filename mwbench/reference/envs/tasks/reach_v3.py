# Frozen copy of metaworld_tpu_torch/envs/tasks/reach_v3.py at commit 3742bce; imports renamed.
"""reach-v3: move the tcp to a target point (batched counterpart of the JAX
package's `envs/tasks/reach_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec, norm
from mwbench.reference.envs.scene_builder import FreeObj, build_scene
from mwbench.reference.envs.tasks import common
from mwbench.reference.rewards import utils as reward_utils

_OBJ_LOW = (-0.1, 0.6, 0.02)
_OBJ_HIGH = (0.1, 0.7, 0.02)
_GOAL_LOW = (-0.1, 0.8, 0.05)
_GOAL_HIGH = (0.1, 0.9, 0.3)
_HAND_INIT = (0.0, 0.6, 0.2)
_HAND_LOW = (-0.5, 0.40, 0.05)
_HAND_HIGH = (0.5, 1.0, 0.5)


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.15


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    obj = rand[:, :3]
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
        near_object=tcp_to_target,
        grasp_success=1.0,
        grasp_reward=tcp_to_target,
        in_place_reward=in_place,
        obj_to_target=tcp_to_target,
    )


@registry.register("reach-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.02, half_h=0.02, graspable=True, grasp_halfwidth=0.022)],
        mocap_low=_HAND_LOW,
        mocap_high=_HAND_HIGH,
    )
    return TaskSpec(
        name="reach-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.concatenate([_OBJ_LOW, _GOAL_LOW]),
        rand_high=np.concatenate([_OBJ_HIGH, _GOAL_HIGH]),
        hand_init_pos=np.asarray(_HAND_INIT),
        goal_low=np.asarray(_GOAL_LOW),
        goal_high=np.asarray(_GOAL_HIGH),
        reset_fn=_reset,
        reward_fn=_reward,
        n_obs_obj=1,
    )
