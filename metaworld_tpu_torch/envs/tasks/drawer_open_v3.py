"""drawer-open-v3: hook the drawer handle and pull it open (batched
counterpart of the JAX package's `envs/tasks/drawer_open_v3.py`)."""

from __future__ import annotations

import numpy as np

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, add_const, mul_const, norm
from metaworld_tpu_torch.envs.scene_builder import FixtureJoint, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.physics import engine
from metaworld_tpu_torch.rewards import utils as reward_utils
from metaworld_tpu_torch.types import JointType

_MAX_DIST = 0.2
_HANDLE_OFF = (0.0, -0.17, 0.09)


def _reset(spec: TaskSpec, rand, gen):
    drawer = rand[:, :3]
    return dict(
        fixture_pos=drawer,
        target=add_const(drawer, (0.0, -0.16 - _MAX_DIST, 0.09)),
        obj_init_pos=common.pad_obj_pos(add_const(drawer, _HANDLE_OFF)),
    )


def handle_obs(spec: TaskSpec, state):
    handle = engine.fixture_handle_pos(
        spec.consts(state.sim.hand.device).scene, state.sim.fixture_pos,
        state.sim.joint_q)
    return handle, common.live_quat(spec, state)


def _reward(spec: TaskSpec, state, obs, action):
    gripper = obs[:, :3]
    handle = obs[:, 4:7]
    handle_error = norm(handle - state.target)
    reward_for_opening = reward_utils.tolerance(
        handle_error, bounds=(0, 0.02), margin=_MAX_DIST, sigmoid="long_tail"
    )
    handle_pos_init = add_const(state.target, (0.0, _MAX_DIST, 0.0))
    scale = (3.0, 3.0, 1.0)
    gripper_error = mul_const(handle - gripper, scale)
    gripper_error_init = mul_const(handle_pos_init - state.init_tcp, scale)
    reward_for_caging = reward_utils.tolerance(
        norm(gripper_error),
        bounds=(0, 0.01),
        margin=norm(gripper_error_init),
        sigmoid="long_tail",
    )
    reward = 5.0 * (reward_for_caging + reward_for_opening)
    return common.eval_out(
        reward=reward,
        success=handle_error <= 0.03,
        near_object=norm(handle - gripper) <= 0.03,
        grasp_success=obs[:, 3] > 0,
        grasp_reward=reward_for_caging,
        in_place_reward=reward_for_opening,
        obj_to_target=handle_error,
    )


@registry.register("drawer-open-v3")
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
        name="drawer-open-v3",
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
        obj_quat0=None,
        quat_style=("wxyz", "wxyz"),
        n_obs_obj=1,
    )
