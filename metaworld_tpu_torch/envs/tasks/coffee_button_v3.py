"""coffee-button-v3: press the coffee machine's brew button (batched
counterpart of the JAX package's `envs/tasks/coffee_button_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, add_const, norm
from metaworld_tpu_torch.envs.scene_builder import FixtureJoint, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.envs.tasks.drawer_open_v3 import handle_obs
from metaworld_tpu_torch.rewards import utils as reward_utils
from metaworld_tpu_torch.types import JointType

_OBJ_LOW = (-0.1, 0.8, -0.001)
_OBJ_HIGH = (0.1, 0.9, 0.001)
_BTN_OFF = (0.0, -0.2204, 0.2993)
_MAX_DIST = 0.03


def _reset(spec: TaskSpec, rand, gen):
    machine = rand[:, :3]
    return dict(
        fixture_pos=machine,
        target=add_const(machine, (0.0, -0.22 + _MAX_DIST, 0.3)),
        obj_init_pos=common.pad_obj_pos(add_const(machine, _BTN_OFF)),
        extras=common.extras_vec(torch.full_like(machine[:, 0], _MAX_DIST)),
    )


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    tcp = state.sim.hand
    tcp_to_obj = norm(obj - tcp)
    tcp_to_obj_init = norm(obj - state.init_tcp)
    obj_to_target = torch.abs(state.target[:, 1] - obj[:, 1])
    tcp_closed = torch.clamp(obs[:, 3], min=0.0)
    near_button = reward_utils.tolerance(
        tcp_to_obj, bounds=(0, 0.05), margin=tcp_to_obj_init, sigmoid="long_tail"
    )
    button_pressed = reward_utils.tolerance(
        obj_to_target, bounds=(0, 0.005), margin=state.extras[:, 0],
        sigmoid="long_tail"
    )
    reward = 2.0 * reward_utils.hamacher_product(tcp_closed, near_button)
    reward = torch.where(tcp_to_obj <= 0.05, reward + 8.0 * button_pressed, reward)
    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.02,
        near_object=tcp_to_obj <= 0.05,
        grasp_success=obs[:, 3] > 0,
        grasp_reward=near_button,
        in_place_reward=button_pressed,
        obj_to_target=obj_to_target,
    )


@registry.register("coffee-button-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        joints=[FixtureJoint(
            kind=JointType.SLIDE, axis=(0.0, 1.0, 0.0), anchor=_BTN_OFF,
            range=(0.0, 0.063), damping=1.0, stiffness=0.0, springref=0.0,
            inertia=0.101, mass=0.1, com=(0.0, -0.19, 0.3),
            handle_radius=0.029, face_radius=0.032,
        )],
        # the coffee machine's collision shell (sawyer_coffee.xml cm_link
        # geoms): base column, dispenser head, and the frame around the
        # button bore
        boxes=[
            StaticBox(pos=(0.0, 0.0, 0.115), size=(0.1, 0.098, 0.115),
                      rel_fixture=True),
            StaticBox(pos=(0.0, 0.0, 0.3), size=(0.1, 0.098, 0.07),
                      rel_fixture=True),
            StaticBox(pos=(0.0, -0.133, 0.248), size=(0.1, 0.05, 0.018),
                      rel_fixture=True),
            StaticBox(pos=(0.0, -0.133, 0.352), size=(0.1, 0.05, 0.018),
                      rel_fixture=True),
            StaticBox(pos=(-0.069, -0.133, 0.3), size=(0.031, 0.05, 0.035),
                      rel_fixture=True),
            StaticBox(pos=(0.069, -0.133, 0.3), size=(0.031, 0.05, 0.035),
                      rel_fixture=True),
        ],
        mocap_low=(-0.5, 0.4, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="coffee-button-v3",
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
        obj_quat0=None,
        quat_style=("wxyz", "wxyz"),
        n_obs_obj=1,
    )
