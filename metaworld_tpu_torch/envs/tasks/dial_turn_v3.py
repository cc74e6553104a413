"""dial-turn-v3: rotate the dial knob about 90 degrees (batched counterpart
of the JAX package's `envs/tasks/dial_turn_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, add_const, norm
from metaworld_tpu_torch.envs.scene_builder import FixtureJoint, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.physics import engine
from metaworld_tpu_torch.rewards import utils as reward_utils
from metaworld_tpu_torch.types import JointType

_R = 0.07
_PUSH_OFF = (0.05, 0.02, 0.09)


def _reset(spec: TaskSpec, rand, gen):
    dial = rand[:, :3]
    knob0 = add_const(dial, (0.0, -0.05, 0.0))
    return dict(
        fixture_pos=dial,
        target=add_const(dial, (0.0, 0.03, 0.03)),
        obj_init_pos=common.pad_obj_pos(add_const(knob0, _PUSH_OFF)),
    )


def _obs(spec: TaskSpec, state):
    # the knob (the contact point) rises 0.07 above the dial face; the
    # observed site sits at its base
    handle = engine.fixture_handle_pos(
        spec.consts(state.sim.hand.device).scene, state.sim.fixture_pos,
        state.sim.joint_q)
    return add_const(handle, (0.0, 0.0, -0.07)), common.live_quat(spec, state)


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    push_pos = add_const(obj, _PUSH_OFF)
    tcp = state.sim.hand
    target = state.target
    obj_init = state.obj_init_pos[:, 0]
    target_to_obj = norm(obj - target)
    target_to_obj_init = norm(obj_init - target)
    in_place = reward_utils.tolerance(
        target_to_obj, bounds=(0, _R),
        margin=torch.abs(target_to_obj_init - _R), sigmoid="long_tail",
    )
    dial_reach_radius = 0.005
    tcp_to_obj = norm(push_pos - tcp)
    tcp_to_obj_init = norm(obj_init - state.init_tcp)
    reach = reward_utils.tolerance(
        tcp_to_obj, bounds=(0, dial_reach_radius),
        margin=torch.abs(tcp_to_obj_init - dial_reach_radius), sigmoid="gaussian",
    )
    gripper_closed = torch.clamp(torch.clamp(action[:, -1], min=0.0), max=1.0)
    reach = reward_utils.hamacher_product(reach, gripper_closed)
    reward = 10.0 * reward_utils.hamacher_product(reach, in_place)
    return common.eval_out(
        reward=reward,
        success=target_to_obj <= _R,
        near_object=tcp_to_obj <= 0.01,
        grasp_success=1.0,
        grasp_reward=reach,
        in_place_reward=in_place,
        obj_to_target=target_to_obj,
    )


@registry.register("dial-turn-v3")
def make_spec(task_id: int) -> TaskSpec:
    scene = build_scene(
        joints=[FixtureJoint(
            kind=JointType.HINGE, axis=(0.0, 0.0, -1.0), anchor=(0.0, 0.0, 0.0),
            arm=(0.0, -0.05, 0.07), range=(-0.2, 3.0), damping=1.5, inertia=0.08,
            # not hookable: the claw's side pushes the pin round
            handle_radius=0.035,
        )],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name="dial-turn-v3",
        task_id=task_id,
        scene=scene,
        rand_low=np.array([-0.1, 0.7, 0.0]),
        rand_high=np.array([0.1, 0.8, 0.0]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([-0.1, 0.73, 0.0299]),
        goal_high=np.array([0.1, 0.83, 0.0301]),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=_obs,
        obj_quat0=None,
        quat_style=("wxyz", "wxyz"),
        n_obs_obj=1,
    )
