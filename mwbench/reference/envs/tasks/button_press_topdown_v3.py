# Frozen copy of metaworld_tpu_torch/envs/tasks/button_press_topdown_v3.py at commit 3742bce; imports renamed.
"""button-press-topdown-v3: press the button from above (batched
counterpart of the JAX package's `envs/tasks/button_press_topdown_v3.py`)."""

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

_OBJ_LOW = (-0.1, 0.8, 0.115)
_OBJ_HIGH = (0.1, 0.9, 0.115)
_BTN_OFF = (0.0, 0.0, 0.1935)
_TARGET_OFF_Z = 0.1


def _reset(spec: TaskSpec, rand, gen):
    box = rand[:, :3]
    target = add_const(box, (0.0, 0.0, _TARGET_OFF_Z))
    start = add_const(box, _BTN_OFF)
    return dict(
        fixture_pos=box,
        target=target,
        obj_init_pos=common.pad_obj_pos(start),
        extras=common.extras_vec(torch.abs(target[:, 2] - start[:, 2])),
    )


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    tcp = state.sim.hand
    tcp_to_obj = norm(obj - tcp)
    tcp_to_obj_init = norm(obj - state.init_tcp)
    obj_to_target = torch.abs(state.target[:, 2] - obj[:, 2])
    tcp_closed = 1.0 - obs[:, 3]
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


def make_topdown_scene(wall: bool = False):
    boxes = [StaticBox(pos=(0.0, 0.0, 0.04625), size=(0.12, 0.05, 0.04625),
                       rel_fixture=True, blocks_hand=False)]
    if wall:
        # the wall between the hand's start and the box
        # (sawyer_button_press_topdown_wall.xml)
        boxes.append(StaticBox(pos=(0.1, 0.7, 0.075), size=(0.1, 0.01, 0.075)))
    return build_scene(
        joints=[FixtureJoint(
            kind=JointType.SLIDE, axis=(0.0, 0.0, -1.0), anchor=_BTN_OFF,
            range=(0.0, 0.086), damping=1.0, stiffness=0.5, springref=-0.5,
            inertia=0.011, mass=0.01, com=(0.0, 0.0, 0.1935),
            handle_radius=0.0, face_radius=0.0425, press_off=(0.0, 0.0, -0.022),
        )],
        boxes=boxes,
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )


@registry.register("button-press-topdown-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="button-press-topdown-v3",
        task_id=task_id,
        scene=make_topdown_scene(),
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
