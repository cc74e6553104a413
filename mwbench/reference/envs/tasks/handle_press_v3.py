# Frozen copy of metaworld_tpu_torch/envs/tasks/handle_press_v3.py at commit 3742bce; imports renamed.
"""handle-press-v3: press the box handle lever down (batched counterpart of
the JAX package's `envs/tasks/handle_press_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from mwbench.reference.envs import registry
from mwbench.reference.envs.core import TaskSpec, add_const, norm
from mwbench.reference.envs.scene_builder import FixtureJoint, StaticBox, build_scene
from mwbench.reference.envs.tasks import common
from mwbench.reference.physics import engine
from mwbench.reference.rewards import utils as reward_utils
from mwbench.reference.types import MAX_OBJ, JointType

_R = 0.02


def handle_boxes(side: bool):
    """The handle machine's collision shells: two tall side plates, a
    center wedge and a small base pad; the sideways machine is the same
    body yawed +90 degrees."""
    raw = [((0.0605, 0.0062, 0.1036), (0.0259, 0.1467, 0.1555)),
           ((-0.0605, 0.0062, 0.1036), (0.0259, 0.1467, 0.1555)),
           ((0.0, 0.0286, 0.1084), (0.0348, 0.0881, 0.1156)),
           ((0.0, -0.082, 0.014), (0.035, 0.028, 0.014))]
    out = []
    for pos, size in raw:
        if side:
            pos = (-pos[1], pos[0], pos[2])
            size = (size[1], size[0], size[2])
        out.append(StaticBox(pos=pos, size=size, rel_fixture=True))
    return out


def make_handle_scene(handle_off, press: bool, hi=0.16, side=False):
    """The handle as a capsule bar on a slide joint; the reported handle
    point sits on top of the bar, 0.022 above its center."""
    lo, hi = ((0.0, hi) if press else (-0.105, hi))
    return build_scene(
        joints=[FixtureJoint(
            kind=JointType.SLIDE, axis=(0.0, 0.0, -1.0) if press else (0.0, 0.0, 1.0),
            anchor=handle_off, range=(lo, hi), damping=30.0, inertia=0.003,
            mass=0.002, handle_radius=0.022, face_radius=0.07,
            face_dir=(0.0, 1.0, 0.0) if side else (1.0, 0.0, 0.0),
            press_off=(0.0, 0.0, -0.022),
            hookable=not press,
        )],
        boxes=handle_boxes(side),
        mocap_low=(-0.5, 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )


def press_reset(handle_off, target_off):
    def _reset(spec: TaskSpec, rand, gen):
        box = rand[:, :3]
        return dict(
            fixture_pos=box,
            target=add_const(box, target_off),
            obj_init_pos=common.pad_obj_pos(add_const(box, handle_off)),
        )
    return _reset


def handle_obs(spec: TaskSpec, state):
    """The handle point, and zero quaternions."""
    handle = engine.fixture_handle_pos(
        spec.consts(state.sim.hand.device).scene, state.sim.fixture_pos,
        state.sim.joint_q)
    return handle, torch.zeros(handle.shape[0], MAX_OBJ, 4, device=handle.device)


def press_reward(spec: TaskSpec, state, obs, action):
    """The shared press reward of the two press tasks."""
    obj = obs[:, 4:7]
    tcp = state.sim.hand
    target = state.target
    target_to_obj = torch.abs(obj[:, 2] - target[:, 2])
    target_to_obj_init = torch.abs(state.obj_init_pos[:, 0, 2] - target[:, 2])
    in_place = reward_utils.tolerance(
        target_to_obj, bounds=(0, _R),
        margin=torch.abs(target_to_obj_init - _R), sigmoid="long_tail",
    )
    handle_radius = 0.02
    tcp_to_obj = norm(obj - tcp)
    tcp_to_obj_init = norm(state.obj_init_pos[:, 0] - state.init_tcp)
    reach = reward_utils.tolerance(
        tcp_to_obj, bounds=(0, handle_radius),
        margin=torch.abs(tcp_to_obj_init - handle_radius), sigmoid="long_tail",
    )
    reward = reward_utils.hamacher_product(reach, in_place)
    reward = torch.where(target_to_obj <= _R, 1.0, reward)
    reward = reward * 10.0
    return common.eval_out(
        reward=reward,
        success=target_to_obj <= _R,
        near_object=tcp_to_obj <= 0.05,
        grasp_success=1.0,
        grasp_reward=reach,
        in_place_reward=in_place,
        obj_to_target=target_to_obj,
    )


@registry.register("handle-press-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="handle-press-v3",
        task_id=task_id,
        scene=make_handle_scene((0.0, -0.216, 0.171), press=True),
        rand_low=np.array([-0.1, 0.8, -0.001]),
        rand_high=np.array([0.1, 0.9, 0.001]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([-0.1, 0.55, 0.04]),
        goal_high=np.array([0.1, 0.70, 0.08]),
        reset_fn=press_reset((0.0, -0.216, 0.171), (0.0, -0.216, 0.075)),
        reward_fn=press_reward,
        obs_fn=handle_obs,
        n_obs_obj=1,
    )
