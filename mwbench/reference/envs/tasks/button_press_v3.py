# Frozen copy of metaworld_tpu_torch/envs/tasks/button_press_v3.py at commit 3742bce; imports renamed.
"""button-press-v3: press the button horizontally, toward +y (batched
counterpart of the JAX package's `envs/tasks/button_press_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec, add_const, norm
from mwbench.reference.envs.scene_builder import FixtureJoint, StaticBox, build_scene
from mwbench.reference.envs.tasks import common
from mwbench.reference.envs.tasks.drawer_open_v3 import handle_obs
from mwbench.reference.rewards import utils as reward_utils
from mwbench.reference.types import JointType

_OBJ_LOW = (-0.1, 0.85, 0.115)
_OBJ_HIGH = (0.1, 0.9, 0.115)
_BTN_OFF = (0.0, -0.193, 0.0)   # button face rel. box at rest
_TARGET_OFF_Y = -0.1            # hole site rel. box


def button_reset(rand):
    """Reset overrides of the horizontal buttons: the box from the task
    vector, the target at the hole site, the press depth in extras[0]."""
    box = rand[:, :3]
    target = add_const(box, (0.0, _TARGET_OFF_Y, 0.0))
    start = add_const(box, _BTN_OFF)
    return dict(
        fixture_pos=box,
        target=target,
        obj_init_pos=common.pad_obj_pos(start),
        extras=common.extras_vec(torch.abs(target[:, 1] - start[:, 1])),
    )


def _reset(spec: TaskSpec, rand, gen):
    return button_reset(rand)


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


def button_joint(stop: float) -> FixtureJoint:
    """The horizontal button's slide, pressed in to `stop`."""
    return FixtureJoint(
        kind=JointType.SLIDE, axis=(0.0, 1.0, 0.0), anchor=_BTN_OFF,
        range=(0.0, stop), damping=1.0, stiffness=0.5, springref=-0.5,
        inertia=0.011, mass=0.01, com=(0.0, -0.1935, 0.0),
        handle_radius=0.0, face_radius=0.0425,
    )


BUTTON_BOX = StaticBox(pos=(0.0, 0.012, 0.0), size=(0.12, 0.102, 0.115),
                       rel_fixture=True, blocks_hand=False)


@registry.register("button-press-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        joints=[button_joint(0.086)],
        boxes=[BUTTON_BOX],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="button-press-v3",
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
