# Frozen copy of metaworld_tpu_torch/envs/tasks/door_close_v3.py at commit 3742bce; imports renamed.
"""door-close-v3: push the open door shut (batched counterpart of the JAX
package's `envs/tasks/door_close_v3.py`).

The joint coordinate measures closing from the open pose (q_close =
q_mujoco + pi/2), so the arm is the door-open arm rotated by R(z, -pi/2)
and the reset sits at q = 0. The panel is not hookable."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec, add_const, norm
from mwbench.reference.envs.scene_builder import FixtureJoint, build_scene
from mwbench.reference.envs.tasks import common
from mwbench.reference.envs.tasks.drawer_open_v3 import handle_obs
from mwbench.reference.rewards import utils as reward_utils
from mwbench.reference.types import JointType

_PIVOT = (-0.185, -0.1, 0.0)
_ARM = (-0.10714, -0.375722, 0.0)  # R(z, -pi/2) @ (0.375722, -0.10714, 0)


def _reset(spec: TaskSpec, rand, gen):
    door = rand[:, :3]
    # obj_init_pos is the door body, so the in_place margin is body-based
    # while the observation tracks the handle
    return dict(
        fixture_pos=door,
        target=add_const(door, (0.2, -0.2, 0.0)),
        obj_init_pos=common.pad_obj_pos(door),
    )


def _reward(spec: TaskSpec, state, obs, action):
    target_radius = 0.05
    tcp = state.sim.hand
    obj = obs[:, 4:7]
    target = state.target
    tcp_to_target = norm(tcp - target)
    obj_to_target = norm(obj - target)
    in_place_margin = norm(state.obj_init_pos[:, 0] - target)
    in_place = reward_utils.tolerance(
        obj_to_target, bounds=(0, target_radius), margin=in_place_margin,
        sigmoid="gaussian",
    )
    hand_margin = norm(state.hand_init - obj) + 0.1
    hand_in_place = reward_utils.tolerance(
        tcp_to_target, bounds=(0, 0.25 * target_radius), margin=hand_margin,
        sigmoid="gaussian",
    )
    reward = 3.0 * hand_in_place + 6.0 * in_place
    reward = torch.where(obj_to_target < target_radius, 10.0, reward)
    return common.eval_out(
        reward=reward,
        success=obj_to_target <= 0.08,
        near_object=0.0,
        grasp_success=1.0,
        grasp_reward=1.0,
        in_place_reward=in_place,
        obj_to_target=obj_to_target,
    )


@registry.register("door-close-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        joints=[FixtureJoint(
            kind=JointType.HINGE, axis=(0.0, 0.0, 1.0), anchor=_PIVOT, arm=_ARM,
            range=(-0.214, 1.5708), damping=2.0, inertia=0.151, mass=2.23,
            handle_radius=0.023, face_radius=0.097, face_dir=(0.0, 0.0, 1.0),
            panel=True, panel_off=0.12,
        )],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="door-close-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([0.0, 0.85, 0.15]),
        rand_high=np.array([0.1, 0.95, 0.15]),
        hand_init_pos=np.array([-0.5, 0.6, 0.2]),
        goal_low=np.array([0.2, 0.65, 0.1499]),
        goal_high=np.array([0.3, 0.75, 0.1501]),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=handle_obs,
        obj_quat0=np.array([[0.595, 0.382, -0.595, 0.382],
                            [1.0, 0.0, 0.0, 0.0]]),
        quat_style=("xyzw", "xyzw"),
        quat_joint=(0, -1),
        n_obs_obj=1,
    )
