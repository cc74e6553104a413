# Frozen copy of metaworld_tpu_torch/envs/tasks/door_lock_v3.py at commit 3742bce; imports renamed.
"""door-lock-v3: push the door's lock lever down (batched counterpart of
the JAX package's `envs/tasks/door_lock_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec, add_const, mul_const, norm
from mwbench.reference.envs.scene_builder import FixtureJoint, StaticBox, build_scene
from mwbench.reference.envs.tasks import common
from mwbench.reference.envs.tasks.drawer_open_v3 import handle_obs
from mwbench.reference.physics import engine
from mwbench.reference.rewards import utils as reward_utils
from mwbench.reference.types import JointType

_LOCK_OFF = (0.09, -0.158, 0.071)
_LOCK_LEN = 0.1
_AXIS = (-0.551, 0.0, -0.835)  # unit chord of the lever's arc


def _reset(spec: TaskSpec, rand, gen):
    door = rand[:, :3]
    # obj_init_pos and target key off the lock_link body frame, not the
    # observed lever site
    lock_body = add_const(door, (0.0, -0.118, 0.061))
    return dict(
        fixture_pos=door,
        target=add_const(lock_body, (0.0, -0.04, -0.1)),
        obj_init_pos=common.pad_obj_pos(lock_body),
    )


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    left_pad, _ = engine.pad_positions(state.sim)
    # the reference's initial distance is a live view of the current one
    tcp_to_obj = norm(mul_const(obj - left_pad, (0.25, 1.0, 0.5)))
    obj_to_target = torch.abs(state.target[:, 2] - obj[:, 2])
    tcp_opened = torch.clamp(obs[:, 3], min=0.0)
    near_lock = reward_utils.tolerance(
        tcp_to_obj, bounds=(0, 0.01), margin=tcp_to_obj, sigmoid="long_tail"
    )
    lock_pressed = reward_utils.tolerance(
        obj_to_target, bounds=(0, 0.005), margin=_LOCK_LEN, sigmoid="long_tail"
    )
    reward = 2.0 * reward_utils.hamacher_product(tcp_opened, near_lock)
    reward = reward + 8.0 * lock_pressed
    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.02,
        near_object=tcp_to_obj <= 0.05,
        grasp_success=obs[:, 3] > 0,
        grasp_reward=near_lock,
        in_place_reward=lock_pressed,
        obj_to_target=obj_to_target,
    )


@registry.register("door-lock-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        joints=[FixtureJoint(
            kind=JointType.SLIDE, axis=_AXIS, anchor=_LOCK_OFF,
            range=(0.0, 0.125), damping=6.0, inertia=0.3, handle_radius=0.03,
        )],
        # the door body; its panel is left out, as in the JAX package
        boxes=[StaticBox(pos=(0.0, 0.0, 0.0), size=(0.2, 0.02, 0.22),
                         rel_fixture=True)],
        mocap_low=(-0.5, 0.40, -0.15),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="door-lock-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([-0.1, 0.8, 0.15]),
        rand_high=np.array([0.1, 0.85, 0.15]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.asarray((-0.5, 0.40, -0.15)),
        goal_high=np.asarray((0.5, 1.0, 0.5)),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=handle_obs,
        obj_quat0=None,
        quat_style=("wxyz", "wxyz"),
        n_obs_obj=1,
    )
