"""door-open-v3: grab the door handle and pull the door open (batched
counterpart of the JAX package's `envs/tasks/door_open_v3.py`)."""

from __future__ import annotations

import math

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, add_const, norm
from metaworld_tpu_torch.envs.scene_builder import FixtureJoint, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.physics import engine
from metaworld_tpu_torch.rewards import utils as reward_utils
from metaworld_tpu_torch.types import JointType

_PIVOT = (-0.185, -0.1, 0.0)
_ARM = (0.375722, -0.10714, 0.0)


def _reset(spec: TaskSpec, rand, gen):
    door = rand[:, :3]
    return dict(
        fixture_pos=door,
        target=add_const(door, (-0.3, -0.45, 0.0)),
        obj_init_pos=common.pad_obj_pos(add_const(add_const(door, _PIVOT), _ARM)),
    )


def _obs(spec: TaskSpec, state):
    handle = engine.fixture_handle_pos(
        spec.consts(state.sim.hand.device).scene, state.sim.fixture_pos,
        state.sim.joint_q)
    return handle, common.live_quat(spec, state)


def _reward(spec: TaskSpec, state, obs, action):
    theta = state.sim.joint_q[:, 0]
    reward_grab = (torch.clamp(action[:, 3], -1.0, 1.0) + 1.0) / 2.0

    hand = obs[:, :3]
    door = add_const(obs[:, 4:7], (-0.05, 0.0, 0.0))
    threshold = 0.12
    radius = norm(hand[:, :2] - door[:, :2])
    floor = torch.where(
        radius <= threshold,
        0.0,
        0.04 * torch.log(torch.clamp(radius - threshold, min=1e-12)) + 0.4,
    )
    above_floor = torch.where(
        hand[:, 2] >= floor,
        1.0,
        reward_utils.tolerance(
            floor - hand[:, 2], bounds=(0.0, 0.01),
            margin=torch.clamp(floor / 2.0, min=1e-6), sigmoid="long_tail",
        ),
    )
    in_place = reward_utils.tolerance(
        norm(add_const(hand - door, (-0.05, -0.03, 0.01))),
        bounds=(0, threshold / 2.0), margin=0.5, sigmoid="long_tail",
    )
    ready_to_open = reward_utils.hamacher_product(above_floor, in_place)
    door_angle = -theta
    a, b = 0.2, 0.8
    opened = a * (theta < -math.pi / 90.0) + b * reward_utils.tolerance(
        math.pi / 2.0 + math.pi / 6 - door_angle,
        bounds=(0, 0.5), margin=math.pi / 3.0, sigmoid="long_tail",
    )
    reward = (2.0 * reward_utils.hamacher_product(ready_to_open, reward_grab)
              + 8.0 * opened)
    success = torch.abs(obs[:, 4] - state.target[:, 0]) <= 0.08
    reward = torch.where(success, 10.0, reward)
    return common.eval_out(
        reward=reward,
        success=success,
        near_object=ready_to_open,
        grasp_success=reward_grab >= 0.5,
        grasp_reward=reward_grab,
        in_place_reward=opened,
        obj_to_target=0.0,
    )


@registry.register("door-open-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        joints=[FixtureJoint(
            kind=JointType.HINGE, axis=(0.0, 0.0, 1.0), anchor=_PIVOT, arm=_ARM,
            range=(-1.785, 0.0), damping=2.0, inertia=0.151, mass=2.23,
            handle_radius=0.023, face_radius=0.097, face_dir=(0.0, 0.0, 1.0),
            hookable=True, panel=True, panel_off=0.12,
        )],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="door-open-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([0.0, 0.85, 0.15]),
        rand_high=np.array([0.1, 0.95, 0.15]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([-0.3, 0.4, 0.1499]),
        goal_high=np.array([-0.2, 0.5, 0.1501]),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=_obs,
        obj_quat0=np.array([[0.151, 0.691, -0.151, 0.691],
                            [1.0, 0.0, 0.0, 0.0]]),
        quat_style=("xyzw", "xyzw"),
        quat_joint=(0, -1),
        n_obs_obj=1,
    )
