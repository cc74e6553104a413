"""stick-push-v3: grab the stick and push the thermos to the goal (batched
counterpart of the JAX package's `envs/tasks/stick_push_v3.py`)."""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import (
    TaskSpec, add_const, gripper_caging_reward, norm, touching_main_object)
from metaworld_tpu_torch.envs.scene_builder import FreeObj, build_scene
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.rewards import utils as reward_utils

_THERMOS0_COM = (0.25, 0.6, 0.132)   # container body COM (physical)
_THERMOS0_REF_INIT = (0.2, 0.6, 0.0)  # reference get_body_com at reset
_THERMOS_OBS_OFF = (-0.05, 0.0, 0.0)  # observed handle site rel. COM
# The reference's reset leaves the container coasting +x at 0.6793 m/s
# (its 50-step hand servo resolves the stick model's interpenetration and
# only the stick's velocity is zeroed), the same for every goal of both
# stick tasks.
_THERMOS_KICK = np.zeros((2, 3))
_THERMOS_KICK[1, 0] = 0.6793


def stick_scene(link: bool):
    """The stick and the container, a planar 2-dof slide body with viscous
    damping and slide limits; stick-pull (`link`) links the stick to the
    container's handle once inserted."""
    return build_scene(
        objs=[
            FreeObj(radius=0.025, half_x=0.05, half_h=0.02, graspable=True,
                    grasp_halfwidth=0.015, tool_off=(0.13, 0.0, 0.0),
                    droop=-0.34 if link else -0.05),
            FreeObj(radius=0.045, oo_half_x=0.107, half_h=0.132,
                    graspable=False, mass=3.268, planar=True,
                    lin_damping=1.0,
                    xy_range=((0.05, 0.31, 0.45, 0.71) if link
                              else (0.05, 0.40, 0.45, 0.80))),
        ],
        link_enable=link,
        link_handle_off=_THERMOS_OBS_OFF,
        mocap_low=(-0.5, 0.35 if link else 0.40, 0.05),
        mocap_high=(0.5, 1.0, 0.5),
    )


def thermos_obs(spec: TaskSpec, state):
    """The stick at its COM, the container at its handle site."""
    pos = state.sim.obj_pos
    return (torch.stack([pos[:, 0], add_const(pos[:, 1], _THERMOS_OBS_OFF)], dim=1),
            common.live_quat(spec, state))


def good(v):
    return norm(v[:, :2] - v[:, 3:5]) >= 0.1


def stick_reset(rand, target_z):
    """Reset overrides of both stick tasks: the stick from the task vector,
    the container at its rest pose and coasting, the target at `target_z`."""
    n, dev = rand.shape[0], rand.device
    stick = common.vec3(rand[:, 0], rand[:, 1], 0.02)

    def const(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).repeat(
            (n,) + (1,) * np.ndim(a))

    return dict(
        obj_pos=common.pad_obj_pos(stick, const(_THERMOS0_COM)),
        obj_vel=const(_THERMOS_KICK),
        obj_init_pos=common.pad_obj_pos(const(_THERMOS0_REF_INIT)),
        target=common.vec3(rand[:, 3], rand[:, 4], target_z),
        extras=common.extras_vec(stick[:, 0], stick[:, 1], stick[:, 2]),
    )


def _reset(spec: TaskSpec, rand, gen):
    c = spec.consts(rand.device)
    rand = common.sample_until(good, rand, gen, c.rand_low, c.rand_high)
    return stick_reset(rand, 0.132)


def _reward(spec: TaskSpec, state, obs, action):
    target_radius = 0.12
    tcp = state.sim.hand
    stick = add_const(obs[:, 4:7], (0.015, 0.0, 0.0))
    container = obs[:, 11:14]
    tcp_opened = obs[:, 3]
    target = state.target
    stick_init = state.extras[:, :3]

    tcp_to_stick = norm(stick - tcp)
    stick_to_target = norm(stick - target)
    stick_in_place_margin = norm(stick_init - target) - target_radius
    stick_in_place = reward_utils.tolerance(
        stick_to_target, bounds=(0, target_radius), margin=stick_in_place_margin,
        sigmoid="long_tail",
    )
    container_to_target = norm(container - target)
    container_in_place_margin = (norm(state.obj_init_pos[:, 0] - target)
                                 - target_radius)
    container_in_place = reward_utils.tolerance(
        container_to_target, bounds=(0, target_radius),
        margin=container_in_place_margin, sigmoid="long_tail",
    )
    object_grasped = gripper_caging_reward(
        spec, state, action, stick,
        obj_radius=0.04, pad_success_thresh=0.05,
        object_reach_radius=0.01, xz_thresh=0.01, high_density=True,
    )
    holding = (tcp_to_stick < 0.02) & (tcp_opened > 0) & (
        stick[:, 2] - 0.01 > stick_init[:, 2])
    reward = torch.where(
        holding,
        2.0 + 5.0 * stick_in_place + 3.0 * container_in_place,
        object_grasped,
    )
    reward = torch.where(holding & (container_to_target <= target_radius), 10.0,
                         reward)

    grasp_success = (
        touching_main_object(state)
        & (tcp_opened > 0)
        & (obs[:, 6] - 0.02 > 0.02)
    )
    return common.eval_out(
        reward=reward,
        success=(container_to_target <= target_radius) & grasp_success,
        near_object=tcp_to_stick <= 0.03,
        grasp_success=grasp_success,
        grasp_reward=torch.where(holding, 1.0, object_grasped),
        in_place_reward=stick_in_place,
        obj_to_target=container_to_target,
    )


@registry.register("stick-push-v3")
def make_spec(task_id: int) -> TaskSpec:
    return TaskSpec(
        name="stick-push-v3",
        task_id=task_id,
        scene=stick_scene(link=False),
        rand_low=np.array([-0.08, 0.58, 0.0, 0.399, 0.55, 0.1319]),
        rand_high=np.array([-0.03, 0.62, 0.001, 0.401, 0.6, 0.1321]),
        hand_init_pos=np.array([0.0, 0.6, 0.2]),
        goal_low=np.array([0.399, 0.55, 0.1319]),
        goal_high=np.array([0.401, 0.6, 0.1321]),
        reset_fn=_reset,
        reward_fn=_reward,
        obs_fn=thermos_obs,
        n_obs_obj=2,
        quat_style=("xyzw", "zeros"),
    )
