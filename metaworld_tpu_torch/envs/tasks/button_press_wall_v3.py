"""button-press-wall-v3: press the button horizontally with a wall in the
way (batched counterpart of the JAX package's
`envs/tasks/button_press_wall_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, norm
from metaworld_tpu_torch.envs.scene_builder import StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.envs.tasks.button_press_v3 import (
    BUTTON_BOX, button_joint, button_reset)
from metaworld_tpu_torch.envs.tasks.drawer_open_v3 import handle_obs
from metaworld_tpu_torch.rewards import utils as reward_utils

_OBJ_LOW = (-0.05, 0.85, 0.1149)
_OBJ_HIGH = (0.05, 0.9, 0.1151)


def _reset(spec: TaskSpec, rand, gen):
    return button_reset(rand)


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    tcp = state.sim.hand
    tcp_to_obj = norm(obj - tcp)
    tcp_to_obj_init = norm(obj - state.init_tcp)
    obj_to_target = torch.abs(state.target[:, 1] - obj[:, 1])
    near_button = reward_utils.tolerance(
        tcp_to_obj, bounds=(0, 0.01), margin=tcp_to_obj_init, sigmoid="long_tail"
    )
    button_pressed = reward_utils.tolerance(
        obj_to_target, bounds=(0, 0.005), margin=state.extras[:, 0],
        sigmoid="long_tail"
    )
    tcp_status = (1.0 - obs[:, 3]) / 2.0
    far_reward = 2.0 * reward_utils.hamacher_product(tcp_status, near_button)
    close_reward = 2.0 + 2.0 * (1.0 + obs[:, 3]) + 4.0 * torch.square(button_pressed)
    reward = torch.where(tcp_to_obj > 0.07, far_reward, close_reward)
    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.03,
        near_object=tcp_to_obj <= 0.05,
        grasp_success=obs[:, 3] > 0,
        grasp_reward=near_button,
        in_place_reward=button_pressed,
        obj_to_target=obj_to_target,
    )


@registry.register("button-press-wall-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        # the wall caps the claw's approach, so the press parks at 0.0695
        joints=[button_joint(0.0695)],
        boxes=[BUTTON_BOX,
               StaticBox(pos=(0.1, 0.6, 0.075), size=(0.1, 0.01, 0.075))],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="button-press-wall-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.asarray(_OBJ_LOW),
        rand_high=np.asarray(_OBJ_HIGH),
        hand_init_pos=np.array([0.0, 0.4, 0.2]),
        goal_low=np.asarray((-0.5, 0.40, 0.05)),
        goal_high=np.asarray((0.5, 1.0, 0.5)),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=handle_obs,
        quat_style=("wxyz", "wxyz"),
        n_obs_obj=1,
    )
