"""drawer-close-v3: push the open drawer shut (batched counterpart of the
JAX package's `envs/tasks/drawer_close_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, add_const, norm
from metaworld_tpu_torch.envs.scene_builder import FixtureJoint, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.envs.tasks.drawer_open_v3 import handle_obs
from metaworld_tpu_torch.rewards import utils as reward_utils
from metaworld_tpu_torch.types import MAX_JOINT, JointType

_MAX_DIST = 0.15
_R = 0.05
_HANDLE_OFF = (0.0, -0.17, 0.14)


def _reset(spec: TaskSpec, rand, gen):
    drawer = rand[:, :3]
    handle_open = add_const(add_const(drawer, _HANDLE_OFF), (0.0, -_MAX_DIST, 0.0))
    joint_q = torch.zeros(rand.shape[0], MAX_JOINT, device=rand.device)
    joint_q[:, 0] = _MAX_DIST
    return dict(
        fixture_pos=drawer,
        target=add_const(drawer, (0.0, -0.16, 0.09)),
        obj_init_pos=common.pad_obj_pos(handle_open),
        joint_q=joint_q,
    )


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    tcp = state.sim.hand
    target = state.target
    target_to_obj = norm(obj - target)
    target_to_obj_init = norm(state.obj_init_pos[:, 0] - target)
    in_place = reward_utils.tolerance(
        target_to_obj, bounds=(0, _R),
        margin=torch.abs(target_to_obj_init - _R), sigmoid="long_tail",
    )
    handle_reach_radius = 0.005
    tcp_to_obj = norm(obj - tcp)
    tcp_to_obj_init = norm(state.obj_init_pos[:, 0] - state.init_tcp)
    reach = reward_utils.tolerance(
        tcp_to_obj, bounds=(0, handle_reach_radius),
        margin=torch.abs(tcp_to_obj_init - handle_reach_radius),
        sigmoid="gaussian",
    )
    gripper_closed = torch.clamp(torch.clamp(action[:, -1], min=0.0), max=1.0)
    reach = reward_utils.hamacher_product(reach, gripper_closed)
    reward = reward_utils.hamacher_product(reach, in_place)
    reward = torch.where(target_to_obj <= _R + 0.015, 1.0, reward)
    reward = reward * 10.0
    return common.eval_out(
        reward=reward,
        success=target_to_obj <= _R + 0.015,
        near_object=tcp_to_obj <= 0.01,
        grasp_success=1.0,
        grasp_reward=reach,
        in_place_reward=in_place,
        obj_to_target=target_to_obj,
    )


@registry.register("drawer-close-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        joints=[FixtureJoint(
            kind=JointType.SLIDE, axis=(0.0, -1.0, 0.0), anchor=_HANDLE_OFF,
            range=(0.0, 0.16), damping=2.0, inertia=0.381, mass=0.38,
            handle_radius=0.009, face_radius=0.05, face_dir=(1.0, 0.0, 0.0),
            press_off=(0.0, 0.01, 0.0),
        )],
        boxes=[StaticBox(pos=(0.0, 0.01, 0.084), size=(0.12, 0.13, 0.084),
                         rel_fixture=True)],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="drawer-close-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([-0.1, 0.9, 0.0]),
        rand_high=np.array([0.1, 0.9, 0.0]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.asarray((-0.5, 0.40, 0.05)),
        goal_high=np.asarray((0.5, 1.0, 0.5)),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=handle_obs,
        quat_style=("zeros", "zeros"),
        n_obs_obj=1,
    )
