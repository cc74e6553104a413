# Frozen copy of metaworld_tpu_torch/envs/tasks/hammer_v3.py at commit 3742bce; imports renamed.
"""hammer-v3: grab the hammer and drive the nail into the box (batched
counterpart of the JAX package's `envs/tasks/hammer_v3.py`).

The one scene with both a free object (the hammer) and a joint (the nail,
a slide along +y), so its blocks run the kernel's v3 variant."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec, add_const, gripper_caging_reward, norm
from mwbench.reference.envs.scene_builder import FixtureJoint, FreeObj, StaticBox, build_scene
from mwbench.reference.envs.tasks import common
from mwbench.reference.physics import engine
from mwbench.reference.rewards import utils as reward_utils
from mwbench.reference.types import JointType

_BOX = (0.24, 0.85, 0.0)
_NAIL_OFF = (0.0, -0.21, 0.11)
_HEAD_OFF = (0.16, 0.06, 0.0)
_HANDLE_LEN = 0.14
_IDEAL_QUAT = (1.0, 0.0, 0.0, 0.0)


def _reset(spec: TaskSpec, rand, gen):
    hammer = common.vec3(rand[:, 0], rand[:, 1], 0.0)
    return dict(
        fixture_pos=common.const_rows(rand, _BOX),
        obj_pos=common.pad_obj_pos(hammer),
        obj_init_pos=common.pad_obj_pos(hammer),
        target=common.const_rows(rand, (0.24, 0.74, 0.11)),
    )


def _obs(spec: TaskSpec, state):
    """The hammer's COM and the nail head."""
    nail = engine.fixture_handle_pos(
        spec.consts(state.sim.hand.device).scene, state.sim.fixture_pos,
        state.sim.joint_q)
    pos = torch.stack([state.sim.obj_pos[:, 0], nail[:, 0]], dim=1)
    return pos, common.live_quat(spec, state)


def _reward(spec: TaskSpec, state, obs, action):
    hand = obs[:, :3]
    hammer = obs[:, 4:7]
    hammer_head = add_const(hammer, _HEAD_OFF)
    # the handle's x is thresholded to the hand's within half its length
    threshold = _HANDLE_LEN / 2.0
    hx = torch.where(torch.abs(hammer[:, 0] - hand[:, 0]) < threshold,
                     hand[:, 0], hammer[:, 0])
    hammer_threshed = torch.stack([hx, hammer[:, 1], hammer[:, 2]], dim=-1)
    quat_err = norm(add_const(obs[:, 7:11], tuple(-q for q in _IDEAL_QUAT)))
    reward_quat = torch.clamp(1.0 - quat_err / 0.4, min=0.0)
    reward_grab = gripper_caging_reward(
        spec, state, action, hammer_threshed,
        object_reach_radius=0.01, obj_radius=0.015,
        pad_success_thresh=0.02, xz_thresh=0.01, high_density=True,
    )
    a, b = 0.1, 0.9
    pos_error = state.target - hammer_head
    lifted = hammer_head[:, 2] > 0.02
    reward_in_place = a * lifted + b * reward_utils.tolerance(
        norm(pos_error), bounds=(0, 0.02), margin=0.2, sigmoid="long_tail",
    )
    reward = (2.0 * reward_grab + 6.0 * reward_in_place) * reward_quat
    success = state.sim.joint_q[:, 0] > 0.09
    reward = torch.where(success & (reward > 5.0), 10.0, reward)
    return common.eval_out(
        reward=reward,
        success=success,
        near_object=reward_quat,
        grasp_success=reward_grab >= 0.5,
        grasp_reward=reward_grab,
        in_place_reward=reward_in_place,
        obj_to_target=0.0,
    )


@registry.register("hammer-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        objs=[FreeObj(radius=0.035, half_h=0.02, graspable=True,
                      grasp_halfwidth=0.018, tool_off=_HEAD_OFF,
                      grasp_off=(-0.045, 0.0, 0.0), droop=0.12)],
        joints=[FixtureJoint(
            kind=JointType.SLIDE, axis=(0.0, 1.0, 0.0), anchor=_NAIL_OFF,
            range=(0.0, 0.102), damping=12.0, inertia=0.25, handle_radius=0.03,
        )],
        boxes=[StaticBox(pos=(0.0, 0.0, 0.055), size=(0.12, 0.1, 0.055),
                         rel_fixture=True)],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="hammer-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([-0.1, 0.4, 0.0]),
        rand_high=np.array([0.1, 0.5, 0.0]),
        hand_init_pos=np.array([0.0, 0.4, 0.2]),
        goal_low=np.array([0.2399, 0.7399, 0.109]),
        goal_high=np.array([0.2401, 0.7401, 0.111]),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=_obs,
        # the hammer body rests with a slight head-down pitch
        obj_quat0=np.array([[0.99955, 0.0, -0.0299865, 0.0],
                            [1.0, 0.0, 0.0, 0.0]]),
        quat_style=("wxyz", "wxyz"),
        n_obs_obj=2,
    )
