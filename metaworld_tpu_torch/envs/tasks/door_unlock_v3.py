"""door-unlock-v3: push the lock lever sideways to unlock (batched
counterpart of the JAX package's `envs/tasks/door_unlock_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, add_const, mul_const, norm
from metaworld_tpu_torch.envs.scene_builder import FixtureJoint, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.envs.tasks.drawer_open_v3 import handle_obs
from metaworld_tpu_torch.rewards import utils as reward_utils
from metaworld_tpu_torch.types import JointType

_LOCK_OFF = (-0.01, -0.158, -0.029)
_LOCK_LEN = 0.1
_AXIS = (0.781, 0.0, 0.625)  # chord toward the unlocked lever position
_OFFSET = (0.0, 0.055, 0.07)  # the gripper's "shoulder"
_SCALE = (0.25, 1.0, 0.5)


def _reset(spec: TaskSpec, rand, gen):
    door = rand[:, :3]
    # lock_link body frame; the observed lever site is at _LOCK_OFF
    lock_body = add_const(door, (0.0, -0.118, 0.061))
    return dict(
        fixture_pos=door,
        target=add_const(lock_body, (0.1, -0.04, 0.0)),
        obj_init_pos=common.pad_obj_pos(lock_body),
    )


def _reward(spec: TaskSpec, state, obs, action):
    gripper = obs[:, :3]
    lock = obs[:, 4:7]
    shoulder_to_lock = mul_const(add_const(gripper, _OFFSET) - lock, _SCALE)
    shoulder_to_lock_init = mul_const(
        add_const(state.init_tcp, _OFFSET) - state.obj_init_pos[:, 0], _SCALE)
    ready_to_push = reward_utils.tolerance(
        norm(shoulder_to_lock),
        bounds=(0, 0.02),
        margin=norm(shoulder_to_lock_init),
        sigmoid="long_tail",
    )
    obj_to_target = torch.abs(state.target[:, 0] - lock[:, 0])
    pushed = reward_utils.tolerance(
        obj_to_target, bounds=(0, 0.005), margin=_LOCK_LEN, sigmoid="long_tail"
    )
    reward = 2.0 * ready_to_push + 8.0 * pushed
    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.02,
        near_object=norm(shoulder_to_lock) <= 0.05,
        grasp_success=obs[:, 3] > 0,
        grasp_reward=ready_to_push,
        in_place_reward=pushed,
        obj_to_target=obj_to_target,
    )


@registry.register("door-unlock-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        joints=[FixtureJoint(
            kind=JointType.SLIDE, axis=_AXIS, anchor=_LOCK_OFF,
            range=(0.0, 0.128), damping=6.0, inertia=0.3, handle_radius=0.03,
        )],
        # the doorlockA / door_link shells
        boxes=[
            StaticBox(pos=(0.0, -0.1, 0.0), size=(0.184, 0.011, 0.124),
                      rel_fixture=True),
            StaticBox(pos=(0.0, -0.109, 0.061), size=(0.047, 0.013, 0.047),
                      rel_fixture=True),
        ],
        mocap_low=(-0.5, 0.40, -0.15),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="door-unlock-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([-0.1, 0.8, 0.15]),
        rand_high=np.array([0.1, 0.85, 0.15]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([0.0, 0.64, 0.21]),
        goal_high=np.array([0.2, 0.7, 0.2111]),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=handle_obs,
        obj_quat0=None,
        quat_style=("wxyz", "wxyz"),
        n_obs_obj=1,
    )
