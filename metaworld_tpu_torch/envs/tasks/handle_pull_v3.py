"""handle-pull-v3: grab the box handle and pull it up (batched counterpart
of the JAX package's `envs/tasks/handle_pull_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, add_const, gripper_caging_reward, norm
from metaworld_tpu_torch.envs.scene_builder import FixtureJoint, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.envs.tasks.handle_press_v3 import handle_boxes, handle_obs
from metaworld_tpu_torch.rewards import utils as reward_utils
from metaworld_tpu_torch.types import MAX_JOINT, JointType

_R = 0.05


def make_pull_scene(handle_off, hi=0.02, side=False):
    """The handle bar on a hookable slide joint pulled up (+z)."""
    return build_scene(
        joints=[FixtureJoint(
            kind=JointType.SLIDE, axis=(0.0, 0.0, 1.0), anchor=handle_off,
            range=(-0.105, hi), damping=30.0, inertia=0.003, mass=0.002,
            handle_radius=0.022, face_radius=0.07,
            face_dir=(0.0, 1.0, 0.0) if side else (1.0, 0.0, 0.0),
            press_off=(-0.05, 0.0, -0.014) if not side else (0.046, 0.0, 0.0),
            hookable=True,
        )],
        boxes=handle_boxes(side),
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )


def pulled_down(rand):
    """(n, MAX_JOINT) joint coordinates of a handle that starts at -0.1."""
    joint_q = torch.zeros(rand.shape[0], MAX_JOINT, device=rand.device)
    joint_q[:, 0] = -0.1
    return joint_q


def _reset(spec: TaskSpec, rand, gen):
    box = rand[:, :3]
    # the reference's obj_init_pos is the box body, not the handle
    return dict(
        fixture_pos=box,
        target=add_const(box, (0.0, -0.216, 0.172)),
        obj_init_pos=common.pad_obj_pos(box),
        joint_q=pulled_down(rand),
    )


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    target = state.target
    target_to_obj = torch.abs(target[:, 2] - obj[:, 2])
    target_to_obj_init = torch.abs(target[:, 2] - state.obj_init_pos[:, 0, 2])
    in_place = reward_utils.tolerance(
        target_to_obj, bounds=(0, _R), margin=target_to_obj_init,
        sigmoid="long_tail",
    )
    object_grasped = gripper_caging_reward(
        spec, state, action, obj,
        pad_success_thresh=0.05, obj_radius=0.022,
        object_reach_radius=0.01, xz_thresh=0.01, high_density=True,
    )
    reward = reward_utils.hamacher_product(object_grasped, in_place)
    tcp_opened = obs[:, 3]
    tcp_to_obj = norm(obj - state.sim.hand)
    # the reference compares obj y against obj_init z; kept as it is
    bonus = (tcp_to_obj < 0.035) & (tcp_opened > 0) & (
        obj[:, 1] - 0.01 > state.obj_init_pos[:, 0, 2])
    reward = torch.where(bonus, reward + 1.0 + 5.0 * in_place, reward)
    reward = torch.where(target_to_obj < _R, 10.0, reward)
    return common.eval_out(
        reward=reward,
        success=target_to_obj <= _R,
        near_object=tcp_to_obj <= 0.05,
        grasp_success=obs[:, 3] > 0,
        grasp_reward=object_grasped,
        in_place_reward=in_place,
        obj_to_target=target_to_obj,
    )


@registry.register("handle-pull-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="handle-pull-v3",
        task_id=task_id,
        scene=make_pull_scene((0.05, -0.216, 0.163)),
        rand_low=np.array([-0.1, 0.8, -0.001]),
        rand_high=np.array([0.1, 0.9, 0.001]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([-0.1, 0.55, 0.04]),
        goal_high=np.array([0.1, 0.70, 0.18]),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=handle_obs,
        n_obs_obj=1,
    )
