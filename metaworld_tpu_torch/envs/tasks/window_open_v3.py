"""window-open-v3: slide the window pane open (+x) (batched counterpart of
the JAX package's `envs/tasks/window_open_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec, add_const, norm
from metaworld_tpu_torch.envs.scene_builder import FixtureJoint, StaticBox, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.physics import engine
from metaworld_tpu_torch.rewards import utils as reward_utils
from metaworld_tpu_torch.types import MAX_OBJ, JointType

_R = 0.05
_HANDLE_OFF = (-0.04, -0.095, 0.0)


def _reset(spec: TaskSpec, rand, gen):
    window = rand[:, :3]
    return dict(
        fixture_pos=window,
        target=add_const(window, (0.2, 0.0, 0.0)),
        obj_init_pos=common.pad_obj_pos(window),
    )


def window_obs(spec: TaskSpec, state):
    handle = engine.fixture_handle_pos(
        spec.consts(state.sim.hand.device).scene, state.sim.fixture_pos,
        state.sim.joint_q)
    return handle, torch.zeros(handle.shape[0], MAX_OBJ, 4,
                               device=handle.device)


def _reward(spec: TaskSpec, state, obs, action):
    obj = obs[:, 4:7]
    tcp = state.sim.hand
    target = state.target
    target_to_obj = torch.abs(obj[:, 0] - target[:, 0])
    target_to_obj_init = torch.abs(state.obj_init_pos[:, 0, 0] - target[:, 0])
    in_place = reward_utils.tolerance(
        target_to_obj, bounds=(0, _R),
        margin=torch.abs(target_to_obj_init - _R), sigmoid="long_tail",
    )
    handle_radius = 0.02
    tcp_to_obj = norm(obj - tcp)
    handle_init = add_const(state.obj_init_pos[:, 0], _HANDLE_OFF)
    tcp_to_obj_init = norm(handle_init - state.init_tcp)
    reach = reward_utils.tolerance(
        tcp_to_obj, bounds=(0, handle_radius),
        margin=torch.abs(tcp_to_obj_init - handle_radius), sigmoid="long_tail",
    )
    reward = 10.0 * reward_utils.hamacher_product(reach, in_place)
    return common.eval_out(
        reward=reward,
        success=target_to_obj <= _R,
        near_object=tcp_to_obj <= 0.05,
        grasp_success=1.0,
        grasp_reward=reach,
        in_place_reward=in_place,
        obj_to_target=target_to_obj,
    )


def make_window_scene(handle_off, press_off_x):
    return build_scene(
        joints=[FixtureJoint(
            kind=JointType.SLIDE, axis=(1.0, 0.0, 0.0), anchor=handle_off,
            range=(0.0, 0.2), damping=2.0, inertia=0.639, mass=0.638,
            handle_radius=0.008, face_radius=0.045, face_dir=(0.0, 0.0, 1.0),
            press_off=(press_off_x, 0.0, 0.0),
        )],
        boxes=[StaticBox(pos=(0.0, 0.03, 0.0), size=(0.25, 0.02, 0.18),
                         rel_fixture=True)],
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )


@registry.register("window-open-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="window-open-v3",
        task_id=task_id,
        scene=make_window_scene(_HANDLE_OFF, press_off_x=0.026),
        rand_low=np.array([-0.1, 0.7, 0.16]),
        rand_high=np.array([0.1, 0.9, 0.16]),
        hand_init_pos=np.array([0.0, 0.4, 0.2]),
        goal_low=np.asarray((-0.5, 0.40, 0.05)),
        goal_high=np.asarray((0.5, 1.0, 0.5)),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=window_obs,
        n_obs_obj=1,
    )
