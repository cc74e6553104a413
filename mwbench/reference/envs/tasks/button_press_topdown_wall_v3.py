# Frozen copy of metaworld_tpu_torch/envs/tasks/button_press_topdown_wall_v3.py at commit 3742bce; imports renamed.
"""button-press-topdown-wall-v3: press the button from above with a wall in
the approach (batched counterpart of the JAX package's
`envs/tasks/button_press_topdown_wall_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec, norm
from mwbench.reference.envs.tasks import common
from mwbench.reference.envs.tasks.button_press_topdown_v3 import (
    _OBJ_HIGH, _OBJ_LOW, _reset, make_topdown_scene)
from mwbench.reference.envs.tasks.drawer_open_v3 import handle_obs
from mwbench.reference.rewards import utils as reward_utils


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    tcp = state.sim.hand
    tcp_to_obj = norm(obj - tcp)
    tcp_to_obj_init = norm(obj - state.init_tcp)
    obj_to_target = torch.abs(state.target[:, 2] - obj[:, 2])
    tcp_closed = torch.clamp(obs[:, 3], min=0.0)
    near_button = reward_utils.tolerance(
        tcp_to_obj, bounds=(0, 0.01), margin=tcp_to_obj_init, sigmoid="long_tail"
    )
    button_pressed = reward_utils.tolerance(
        obj_to_target, bounds=(0, 0.005), margin=state.extras[:, 0],
        sigmoid="long_tail"
    )
    reward = 5.0 * reward_utils.hamacher_product(tcp_closed, near_button)
    reward = torch.where(tcp_to_obj <= 0.03, reward + 5.0 * button_pressed, reward)
    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.024,
        near_object=tcp_to_obj <= 0.05,
        grasp_success=obs[:, 3] > 0,
        grasp_reward=near_button,
        in_place_reward=button_pressed,
        obj_to_target=obj_to_target,
    )


@registry.register("button-press-topdown-wall-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="button-press-topdown-wall-v3",
        task_id=task_id,
        scene=make_topdown_scene(wall=True),
        rand_low=np.asarray(_OBJ_LOW),
        rand_high=np.asarray(_OBJ_HIGH),
        hand_init_pos=np.array([0.0, 0.4, 0.2]),
        goal_low=np.asarray((-0.5, 0.40, 0.05)),
        goal_high=np.asarray((0.5, 1.0, 0.5)),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=handle_obs,
        obj_quat0=np.array([[0.70710678, -0.70710678, 0.0, 0.0],
                            [1.0, 0.0, 0.0, 0.0]]),
        quat_style=("wxyz", "wxyz"),
        n_obs_obj=1,
    )
