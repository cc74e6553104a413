"""stick-pull-v3: insert the stick through the thermos handle and drag the
thermos to the goal (batched counterpart of the JAX package's
`envs/tasks/stick_pull_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import (
    TaskSpec, add_const, gripper_caging_reward, mul_const, norm,
    touching_main_object)
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.envs.tasks.stick_push_v3 import (
    good, stick_reset, stick_scene, thermos_obs)
from metaworld_tpu_torch.rewards import utils as reward_utils

# stick_end site local pos (assets/objects/assets/stick.xml:5)
_STICK_END_OFF = (0.05, 0.0, 0.0)
_YZ_SCALING = (1.0, 1.0, 2.0)


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    return stick_reset(rand, 0.02)


def _inserted(stick_end, handle):
    return (
        (stick_end[:, 0] >= handle[:, 0])
        & (torch.abs(stick_end[:, 1] - handle[:, 1]) <= 0.040)
        & (torch.abs(stick_end[:, 2] - handle[:, 2]) <= 0.060)
    )


def _reward(spec: TaskSpec, state, obs, action):
    target_radius = 0.05
    tcp = state.sim.hand
    stick = obs[:, 4:7]
    # the stick_end site on the rotating stick
    end_of_stick = state.sim.obj_pos[:, 0] + common.rotate_const(
        state.sim.obj_quat[:, 0], _STICK_END_OFF)
    handle = obs[:, 11:14]
    container = add_const(handle, (0.05, 0.0, 0.0))
    container_init = add_const(state.obj_init_pos[:, 0], (0.05, 0.0, 0.0))
    tcp_opened = obs[:, 3]
    target = state.target
    stick_init = state.extras[:, :3]

    tcp_to_stick = norm(stick - tcp)
    handle_to_target = norm(handle - target)
    stick_to_container = norm(mul_const(stick - container, _YZ_SCALING))
    stick_in_place_margin = norm(mul_const(stick_init - container_init, _YZ_SCALING))
    stick_in_place = reward_utils.tolerance(
        stick_to_container, bounds=(0, target_radius), margin=stick_in_place_margin,
        sigmoid="long_tail",
    )
    stick_to_target = norm(stick - target)
    stick_in_place_2 = reward_utils.tolerance(
        stick_to_target, bounds=(0, target_radius),
        margin=norm(stick_init - target), sigmoid="long_tail",
    )
    container_to_target = norm(container - target)
    container_in_place = reward_utils.tolerance(
        container_to_target, bounds=(0, target_radius),
        margin=norm(state.obj_init_pos[:, 0] - target), sigmoid="long_tail",
    )
    object_grasped = gripper_caging_reward(
        spec, state, action, stick,
        obj_radius=0.014, pad_success_thresh=0.05,
        object_reach_radius=0.01, xz_thresh=0.01, high_density=True,
    )
    grasp_success = (tcp_to_stick < 0.02) & (tcp_opened > 0) & (
        stick[:, 2] - 0.01 > stick_init[:, 2])
    object_grasped = torch.where(grasp_success, 1.0, object_grasped)
    base = reward_utils.hamacher_product(object_grasped, stick_in_place)
    inserted = _inserted(end_of_stick, handle)
    reward = torch.where(grasp_success, 1.0 + base + 5.0 * stick_in_place, base)
    reward = torch.where(
        grasp_success & inserted,
        1.0 + base + 5.0 + 2.0 * stick_in_place_2 + 1.0 * container_in_place,
        reward,
    )
    reward = torch.where(
        grasp_success & inserted & (handle_to_target <= 0.12), 10.0, reward)
    info_grasp = (
        touching_main_object(state) & (tcp_opened > 0) & (obs[:, 6] - 0.02 > 0.02)
    )
    return common.eval_out(
        reward=reward,
        success=(handle_to_target <= 0.12) & inserted,
        near_object=tcp_to_stick <= 0.03,
        grasp_success=info_grasp,
        grasp_reward=object_grasped,
        in_place_reward=stick_in_place,
        obj_to_target=handle_to_target,
    )


@registry.register("stick-pull-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="stick-pull-v3",
        task_id=task_id,
        scene=stick_scene(link=True),
        rand_low=np.array([-0.1, 0.55, 0.0, 0.35, 0.45, 0.0199]),
        rand_high=np.array([0.0, 0.65, 0.001, 0.45, 0.55, 0.0201]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([0.35, 0.45, 0.0199]),
        goal_high=np.array([0.45, 0.55, 0.0201]),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=thermos_obs,
        n_obs_obj=2,
        quat_style=("xyzw", "zeros"),
    )
