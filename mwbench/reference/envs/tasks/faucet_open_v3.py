# Frozen copy of metaworld_tpu_torch/envs/tasks/faucet_open_v3.py at commit 3742bce; imports renamed.
"""faucet-open-v3: rotate the faucet handle counter-clockwise (batched
counterpart of the JAX package's `envs/tasks/faucet_open_v3.py`)."""

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

_R = 0.07


def make_faucet_reward(obj_offset):
    def _reward(spec: TaskSpec, state, obs, action):
        obj = add_const(obs[:, 4:7], obj_offset)
        tcp = state.sim.hand
        target = state.target
        obj_init = state.obj_init_pos[:, 0]
        target_to_obj = norm(obj - target)
        target_to_obj_init = norm(obj_init - target)
        in_place = reward_utils.tolerance(
            target_to_obj, bounds=(0, _R),
            margin=torch.abs(target_to_obj_init - _R), sigmoid="long_tail",
        )
        faucet_reach_radius = 0.01
        tcp_to_obj = norm(obj - tcp)
        tcp_to_obj_init = norm(obj_init - state.init_tcp)
        reach = reward_utils.tolerance(
            tcp_to_obj, bounds=(0, faucet_reach_radius),
            margin=torch.abs(tcp_to_obj_init - faucet_reach_radius),
            sigmoid="gaussian",
        )
        reward = 2.0 * (2.0 * reach + 3.0 * in_place)
        reward = torch.where(target_to_obj <= _R, 10.0, reward)
        return common.eval_out(
            reward=reward,
            success=target_to_obj <= 0.07,
            near_object=tcp_to_obj <= 0.01,
            grasp_success=1.0,
            grasp_reward=reach,
            in_place_reward=in_place,
            obj_to_target=target_to_obj,
        )

    return _reward


def make_faucet_spec(name, task_id, obj_low, obj_high, ccw: bool, obj_offset,
                     arm_x: float):
    sign = 1.0 if ccw else -1.0

    def _reset(spec: TaskSpec, rand, gen):
        base = rand[:, :3]
        return dict(
            fixture_pos=base,
            target=add_const(base, (sign * 0.175, 0.0, 0.125)),
            # the reference's margins use the base position as obj_init
            obj_init_pos=common.pad_obj_pos(base),
        )

    arm = np.array([arm_x, -0.175, 0.0])
    arm_len = np.linalg.norm([arm_x, -0.175, 0.0])
    scene = build_scene(
        # the faucet column the handle swings around (faucet.xml:5-6)
        boxes=[StaticBox(pos=(0.0, 0.0, 0.062), size=(0.018, 0.018, 0.062),
                         rel_fixture=True)],
        joints=[FixtureJoint(
            kind=JointType.HINGE,
            axis=(0.0, 0.0, 1.0) if ccw else (0.0, 0.0, -1.0),
            anchor=(0.0, 0.0, 0.0),
            arm=(arm_x, -0.175, 0.114),
            range=(-0.2, 2.0), damping=2.0, inertia=0.15,
            # the handle is a radial capsule bar the claw hooks and drags
            handle_radius=0.017,
            face_dir=tuple((arm / arm_len).tolist()),
            face_radius=0.055,
            press_off=tuple((-0.055 * arm / arm_len).tolist()),
            hookable=True,
        )],
        mocap_low=(-0.5, 0.40, -0.15),
        mocap_high=(0.5, 1.0, 0.5),
    )
    return TaskSpec(
        name=name,
        task_id=task_id,
        scene=scene,
        rand_low=np.asarray(obj_low),
        rand_high=np.asarray(obj_high),
        hand_init_pos=np.array([0.0, 0.4, 0.2]),
        goal_low=np.asarray((-0.5, 0.40, 0.05)),
        goal_high=np.asarray((0.5, 1.0, 0.5)),
        reset_fn=_reset,
        reward_fn=make_faucet_reward(obj_offset),
        obs_fn=handle_obs,
        quat_style=("wxyz", "wxyz"),
        n_obs_obj=1,
    )


@registry.register("faucet-open-v3")
def make_spec(task_id: int) -> TaskSpec:
    return make_faucet_spec(
        "faucet-open-v3", task_id,
        (-0.05, 0.8, 0.0), (0.05, 0.85, 0.0),
        ccw=True, obj_offset=(-0.04, 0.0, 0.03), arm_x=-0.015,
    )
