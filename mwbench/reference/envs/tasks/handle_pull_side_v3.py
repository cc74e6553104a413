# Frozen copy of metaworld_tpu_torch/envs/tasks/handle_pull_side_v3.py at commit 3742bce; imports renamed.
"""handle-pull-side-v3: grab the sideways box handle and pull it up
(batched counterpart of the JAX package's
`envs/tasks/handle_pull_side_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec, add_const, gripper_caging_reward, norm
from mwbench.reference.envs.tasks import common
from mwbench.reference.envs.tasks.handle_press_v3 import handle_obs
from mwbench.reference.envs.tasks.handle_pull_v3 import make_pull_scene, pulled_down
from mwbench.reference.rewards import utils as reward_utils

_R = 0.05


def _reset(spec: TaskSpec, rand, gen):
    box = rand[:, :3]
    handle0 = add_const(add_const(box, (0.17, 0.0, 0.15)), (0.0, 0.0, -0.1))
    return dict(
        fixture_pos=box,
        target=add_const(box, (0.216, 0.0, 0.172)),
        obj_init_pos=common.pad_obj_pos(handle0),
        joint_q=pulled_down(rand),
    )


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    target = state.target
    target_to_obj = norm(obj - target)
    target_to_obj_init = norm(state.obj_init_pos[:, 0] - target)
    in_place = reward_utils.tolerance(
        target_to_obj, bounds=(0, _R), margin=target_to_obj_init,
        sigmoid="long_tail",
    )
    object_grasped = gripper_caging_reward(
        spec, state, action, obj,
        pad_success_thresh=0.06, obj_radius=0.032,
        object_reach_radius=0.01, xz_thresh=0.01, high_density=True,
    )
    reward = reward_utils.hamacher_product(object_grasped, in_place)
    tcp_opened = obs[:, 3]
    tcp_to_obj = norm(obj - state.sim.hand)
    bonus = (tcp_to_obj < 0.035) & (tcp_opened > 0) & (
        obj[:, 2] - 0.01 > state.obj_init_pos[:, 0, 2])
    reward = torch.where(bonus, reward + 1.0 + 5.0 * in_place, reward)
    reward = torch.where(target_to_obj < _R, 10.0, reward)
    return common.eval_out(
        reward=reward,
        success=target_to_obj <= 0.08,
        near_object=tcp_to_obj <= 0.05,
        grasp_success=obs[:, 3] > 0,
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=target_to_obj,
    )


@registry.register("handle-pull-side-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="handle-pull-side-v3",
        task_id=task_id,
        scene=make_pull_scene((0.17, 0.0, 0.15), hi=0.07, side=True),
        rand_low=np.array([-0.35, 0.65, 0.0]),
        rand_high=np.array([-0.25, 0.75, 0.0]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.asarray((-0.5, 0.40, 0.05)),
        goal_high=np.asarray((0.5, 1.0, 0.5)),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=handle_obs,
        n_obs_obj=1,
    )
