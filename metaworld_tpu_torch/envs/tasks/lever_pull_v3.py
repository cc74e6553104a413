"""lever-pull-v3: lift the lever 90 degrees to vertical (batched
counterpart of the JAX package's `envs/tasks/lever_pull_v3.py`)."""

from __future__ import annotations

import math

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, add_const, mul_const, norm
from metaworld_tpu_torch.envs.scene_builder import FixtureJoint, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.envs.tasks.drawer_open_v3 import handle_obs
from metaworld_tpu_torch.rewards import utils as reward_utils
from metaworld_tpu_torch.types import JointType

_PIVOT = (0.12, 0.0, 0.25)
_ARM = (0.0, -0.2, 0.0)
_SHOULDER_OFF = (0.0, 0.055, 0.07)
_SCALE = (4.0, 1.0, 4.0)


def _reset(spec: TaskSpec, rand, gen):
    body = rand[:, :3]
    return dict(
        fixture_pos=body,
        target=add_const(body, (0.12, 0.0, 0.45)),
        obj_init_pos=common.pad_obj_pos(add_const(add_const(body, _PIVOT), _ARM)),
    )


def _reward(spec: TaskSpec, state, obs, action):
    gripper = obs[:, :3]
    lever = obs[:, 4:7]
    obj_init = state.obj_init_pos[:, 0]
    shoulder_to_lever = mul_const(add_const(gripper, _SHOULDER_OFF) - lever, _SCALE)
    shoulder_to_lever_init = mul_const(
        add_const(state.init_tcp, _SHOULDER_OFF) - obj_init, _SCALE)
    ready_to_lift = reward_utils.tolerance(
        norm(shoulder_to_lever),
        bounds=(0, 0.02),
        margin=norm(shoulder_to_lever_init),
        sigmoid="long_tail",
    )
    # the hinge q runs 0 (horizontal) .. pi/2 (vertical up)
    lever_error = torch.abs(state.sim.joint_q[:, 0] - math.pi / 2.0)
    lever_engagement = reward_utils.tolerance(
        lever_error, bounds=(0, math.pi / 48.0),
        margin=(math.pi / 2.0) - (math.pi / 12.0), sigmoid="long_tail",
    )
    target = state.target
    obj_to_target = norm(lever - target)
    in_place_margin = norm(obj_init - target)
    in_place = reward_utils.tolerance(
        obj_to_target, bounds=(0, 0.04), margin=in_place_margin,
        sigmoid="long_tail",
    )
    reward = 10.0 * reward_utils.hamacher_product(ready_to_lift, in_place)
    return common.eval_out(
        reward=reward,
        success=lever_error <= math.pi / 24,
        near_object=norm(shoulder_to_lever) < 0.03,
        grasp_success=ready_to_lift > 0.9,
        grasp_reward=ready_to_lift,
        in_place_reward=lever_engagement,
        obj_to_target=norm(shoulder_to_lever),
    )


@registry.register("lever-pull-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        boxes=[
            StaticBox(pos=(0.0, 0.0, 0.125), size=(0.041, 0.083, 0.125),
                      rel_fixture=True),
            StaticBox(pos=(0.0, 0.0, 0.25), size=(0.041, 0.083, 0.083),
                      rel_fixture=True),
        ],
        joints=[FixtureJoint(
            kind=JointType.HINGE, axis=(-1.0, 0.0, 0.0), anchor=_PIVOT, arm=_ARM,
            # the physical travel, with the hard lower stop the lever rests on
            range=(0.0, 5.9), damping=2.0, inertia=0.002,
            mass=0.004, com=(-0.006, -0.073, 0.0),
            # the ball rides the claw: a hook that only carries
            handle_radius=0.045, hookable=True, hook_carry=True,
        )],
        mocap_low=(-0.5, 0.40, -0.15),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="lever-pull-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([-0.1, 0.7, 0.0]),
        rand_high=np.array([0.1, 0.8, 0.0]),
        hand_init_pos=np.array([0.0, 0.4, 0.2]),
        goal_low=np.asarray((-0.5, 0.40, 0.05)),
        goal_high=np.asarray((0.5, 1.0, 0.5)),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=handle_obs,
        obj_quat0=np.array([[0.707107, 0.707107, 0.0, 0.0],
                            [1.0, 0.0, 0.0, 0.0]]),
        quat_style=("xyzw", "xyzw"),
        quat_joint=(0, -1),
        n_obs_obj=1,
    )
