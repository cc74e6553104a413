"""window-close-v3: slide the window pane shut (-x) (batched counterpart of
the JAX package's `envs/tasks/window_close_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, add_const, norm
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.envs.tasks.window_open_v3 import make_window_scene, window_obs
from metaworld_tpu_torch.rewards import utils as reward_utils
from metaworld_tpu_torch.types import MAX_JOINT

_R = 0.05
_HANDLE_OFF = (0.01, -0.095, 0.0)


def _reset(spec: TaskSpec, rand, gen):
    window = rand[:, :3]
    handle_init = add_const(add_const(window, _HANDLE_OFF), (0.2, 0.0, 0.0))
    joint_q = torch.zeros(rand.shape[0], MAX_JOINT, device=rand.device)
    joint_q[:, 0] = 0.2
    return dict(
        fixture_pos=window,
        target=window,
        obj_init_pos=common.pad_obj_pos(handle_init),
        joint_q=joint_q,
    )


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    tcp = state.sim.hand
    target = state.target
    target_to_obj = torch.abs(obj[:, 0] - target[:, 0])
    target_to_obj_init = torch.abs(state.obj_init_pos[:, 0, 0] - target[:, 0])
    in_place = reward_utils.tolerance(
        target_to_obj, bounds=(0, _R),
        margin=torch.abs(target_to_obj_init - _R), sigmoid="long_tail",
    )
    handle_radius = 0.02
    tcp_to_obj = norm(obj - tcp)
    tcp_to_obj_init = norm(state.obj_init_pos[:, 0] - state.init_tcp)
    reach = reward_utils.tolerance(
        tcp_to_obj, bounds=(0, handle_radius),
        margin=torch.abs(tcp_to_obj_init - handle_radius), sigmoid="gaussian",
    )
    reward = 10.0 * reward_utils.hamacher_product(reach, in_place)
    return common.eval_out(
        reward=reward,
        success=target_to_obj <= _R,
        near_object=tcp_to_obj <= 0.05,
        grasp_success=1.0,
        grasp_reward=reach,
        in_place_reward=in_place,
        obj_to_target=target_to_obj,
    )


@registry.register("window-close-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="window-close-v3",
        task_id=task_id,
        scene=make_window_scene(_HANDLE_OFF, press_off_x=-0.024),
        rand_low=np.array([0.0, 0.75, 0.2]),
        rand_high=np.array([0.0, 0.9, 0.2]),
        hand_init_pos=np.array([0.0, 0.4, 0.2]),
        goal_low=np.asarray((-0.5, 0.40, 0.05)),
        goal_high=np.asarray((0.5, 1.0, 0.5)),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=window_obs,
        n_obs_obj=1,
    )
