"""Sawyer env core on batched tensors: task specs, observation assembly,
the per-task step tail and reset.

Counterpart of `metaworld_tpu/envs/core.py`. The JAX functions are written
for one env and vmapped; here every function takes a task's whole group of
slots at once: `state` fields are (n, ...) tensors, `action` is (n, 4), and
outputs are (n,) or (n, k). A `TaskSpec` keeps its numpy constants exactly
as the task module wrote them (benchmark goal sampling reads them in
float64); `spec.consts(device)` hands out their float32 tensors, made once
per device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from metaworld_tpu_torch.physics import engine, maths
from metaworld_tpu_torch.rewards import utils as reward_utils
from metaworld_tpu_torch.types import (
    HAND_SPACE_HIGH,
    HAND_SPACE_LOW,
    MAX_JOINT,
    MAX_OBJ,
    MAX_PATH_LENGTH,
    N_EXTRAS,
    EnvState,
    SceneParams,
    SimState,
    StepOut,
    tree_map,
)


@dataclasses.dataclass(frozen=True)
class EvalOut:
    """Reward + metrics of a task's reward_fn, (n,) each."""

    reward: torch.Tensor
    success: torch.Tensor
    near_object: torch.Tensor
    grasp_success: torch.Tensor
    grasp_reward: torch.Tensor
    in_place_reward: torch.Tensor
    obj_to_target: torch.Tensor
    unscaled_reward: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SpecConsts:
    """float32 tensors of one TaskSpec's constants on one device."""

    scene: SceneParams          # unbatched scene row
    hand_init: torch.Tensor     # (3,)
    rand_low: torch.Tensor      # (d,)
    rand_high: torch.Tensor     # (d,)
    quat0: torch.Tensor         # (MAX_OBJ, 4)
    obs_lo_visible: torch.Tensor  # (39,)
    obs_hi_visible: torch.Tensor
    obs_lo_hidden: torch.Tensor
    obs_hi_hidden: torch.Tensor
    report_off: torch.Tensor | None  # (MAX_OBJ, 3) or None


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Static description of one task (see the JAX package's TaskSpec)."""

    name: str
    task_id: int
    scene: SceneParams
    rand_low: np.ndarray
    rand_high: np.ndarray
    hand_init_pos: np.ndarray
    goal_low: np.ndarray
    goal_high: np.ndarray
    # reset_fn(spec, rand (n, d), gen) -> dict of EnvState field overrides
    reset_fn: Callable = None
    # reward_fn(spec, state, obs, action) -> EvalOut
    reward_fn: Callable = None
    # obs_fn(spec, state) -> (obj_pos (n, MAX_OBJ, 3), obj_quat (n, MAX_OBJ, 4))
    obs_fn: Callable = None
    n_obs_obj: int = 1
    obj_quat0: np.ndarray = None
    quat_style: tuple = ("xyzw", "xyzw")
    quat_joint: tuple = (-1, -1)
    # reported-position offset from the physics COM per object slot
    # (MAX_OBJ, 3): the reference reports the body frame origin, which for
    # bodies with offset geoms (coffee-pull's mug) lies off the COM
    obj_report_off: np.ndarray = None
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def rand_dim(self) -> int:
        return int(self.rand_low.shape[0])

    def consts(self, device) -> SpecConsts:
        key = str(torch.device(device))
        if key not in self._cache:
            def f32(a):
                return torch.from_numpy(
                    np.ascontiguousarray(a, dtype=np.float32)).to(device)

            scene = tree_map(
                lambda a: torch.from_numpy(np.ascontiguousarray(
                    a, dtype=np.int32 if np.asarray(a).dtype.kind == "i"
                    else np.float32)).to(device), self.scene)
            quat0 = (np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32),
                             (MAX_OBJ, 1))
                     if self.obj_quat0 is None else self.obj_quat0)
            lo_v, hi_v = obs_bounds(self, True)
            lo_h, hi_h = obs_bounds(self, False)
            self._cache[key] = SpecConsts(
                scene=scene, hand_init=f32(self.hand_init_pos),
                rand_low=f32(self.rand_low), rand_high=f32(self.rand_high),
                quat0=f32(quat0),
                obs_lo_visible=f32(lo_v), obs_hi_visible=f32(hi_v),
                obs_lo_hidden=f32(lo_h), obs_hi_hidden=f32(hi_h),
                report_off=(None if self.obj_report_off is None
                            else f32(self.obj_report_off)))
        return self._cache[key]


# ---------------------------------------------------------------------------
# small batched vector helpers
# ---------------------------------------------------------------------------

def norm(v):
    """L2 norm over the last axis, sqrt(sum(v*v)) as jnp.linalg.norm."""
    return torch.sqrt((v * v).sum(dim=-1))


def add_const(v, c):
    """v (..., k) plus a Python k-tuple, column by column."""
    return torch.stack([v[..., k] + c[k] for k in range(len(c))], dim=-1)


def mul_const(v, c):
    return torch.stack([v[..., k] * c[k] for k in range(len(c))], dim=-1)


# ---------------------------------------------------------------------------
# observation assembly
# ---------------------------------------------------------------------------

def live_obj_quat(spec: TaskSpec, state: EnvState) -> torch.Tensor:
    """(n, MAX_OBJ, 4) object quaternions in the task's convention."""
    c = spec.consts(state.sim.hand.device)
    q_all = state.sim.obj_quat
    rows = []
    for i in range(MAX_OBJ):
        style = spec.quat_style[i] if i < len(spec.quat_style) else "xyzw"
        if style == "zeros":
            rows.append(torch.zeros_like(q_all[:, i]))
            continue
        qd = q_all[:, i]
        j = spec.quat_joint[i] if i < len(spec.quat_joint) else -1
        if j >= 0:
            qj = maths.axis_angle_quat(c.scene.joint_axis[j],
                                       state.sim.joint_q[:, j])
            qd = maths.quat_mul(qj, qd)
        q_abs = maths.quat_mul(qd, c.quat0[i])
        rows.append(maths.quat_to_xyzw(q_abs) if style == "xyzw" else q_abs)
    return torch.stack(rows, dim=1)


def default_obs_fn(spec: TaskSpec, state: EnvState):
    """Objects report their body-frame position (COM plus the task's
    `obj_report_off`) and live orientation."""
    pos = state.sim.obj_pos
    off = spec.consts(pos.device).report_off
    if off is not None:
        pos = pos + off
    return pos, live_obj_quat(spec, state)


def curr_obs18(spec: TaskSpec, state: EnvState) -> torch.Tensor:
    """(n, 18): [hand(3), gripper(1), obj block padded to 14]."""
    hand = engine.obs_hand_pos(state.sim)
    grip = engine.aperture_obs(state.sim)
    obs_fn = spec.obs_fn or default_obs_fn
    obj_pos, obj_quat = obs_fn(spec, state)
    blocks = [hand, grip[:, None]]
    for i in range(spec.n_obs_obj):
        blocks.append(obj_pos[:, i])
        blocks.append(obj_quat[:, i])
    pad = 14 - 7 * spec.n_obs_obj
    if pad:
        blocks.append(torch.zeros_like(hand[:, :1]).expand(-1, pad))
    return torch.cat(blocks, dim=1)


def assemble_obs(spec: TaskSpec, state: EnvState, curr) -> torch.Tensor:
    """(n, 39): [curr18 | prev18 | goal3], goal zeroed when hidden."""
    goal = state.target * state.goal_visible[:, None]
    return torch.cat([curr, state.prev_obs, goal], dim=1)


def obs_bounds(spec: TaskSpec, goal_visible: bool):
    lo_hand = np.asarray(HAND_SPACE_LOW)
    hi_hand = np.asarray(HAND_SPACE_HIGH)
    obj_lo = np.full(14, -np.inf)
    obj_hi = np.full(14, np.inf)
    g_lo = spec.goal_low if goal_visible else np.zeros(3)
    g_hi = spec.goal_high if goal_visible else np.zeros(3)
    low = np.concatenate([lo_hand, [-1.0], obj_lo, lo_hand, [-1.0], obj_lo, g_lo])
    high = np.concatenate([hi_hand, [1.0], obj_hi, hi_hand, [1.0], obj_hi, g_hi])
    return low, high


# ---------------------------------------------------------------------------
# step tail
# ---------------------------------------------------------------------------

def post_step(spec: TaskSpec, state: EnvState, action):
    """Observation assembly + reward after the physics step, for one task's
    group of slots. Returns (new_state, StepOut)."""
    c = spec.consts(action.device)
    curr = curr_obs18(spec, state)
    obs = assemble_obs(spec, state, curr)
    vis = state.goal_visible[:, None] > 0
    lo = torch.where(vis, c.obs_lo_visible, c.obs_lo_hidden)
    hi = torch.where(vis, c.obs_hi_visible, c.obs_hi_hidden)
    obs = torch.minimum(torch.maximum(obs, lo), hi)
    state = state.replace(prev_obs=curr)
    out = spec.reward_fn(spec, state, obs, action)
    step = StepOut(
        obs=obs,
        reward=out.reward,
        terminated=torch.zeros_like(out.reward, dtype=torch.bool),
        truncated=state.path_length >= MAX_PATH_LENGTH,
        success=out.success,
        near_object=out.near_object,
        grasp_success=out.grasp_success,
        grasp_reward=out.grasp_reward,
        in_place_reward=out.in_place_reward,
        obj_to_target=out.obj_to_target,
        unscaled_reward=out.unscaled_reward,
    )
    return state, step


# ---------------------------------------------------------------------------
# reset
# ---------------------------------------------------------------------------

def base_sim_state(spec: TaskSpec, n: int, device) -> SimState:
    """Settled post-reset sim state for n slots: hand servoed to hand_init,
    gripper fully open."""
    c = spec.consts(device)
    hand_init = c.hand_init.expand(n, 3)
    mocap, tcp = engine.settled_hand_state(c.scene, hand_init)
    ones = torch.ones(n, device=device)
    pad_l0, pad_r0 = engine.pad_kinematics(tcp, ones)

    def z(*shape):
        return torch.zeros((n,) + shape, device=device)

    quat = torch.zeros(n, MAX_OBJ, 4, device=device)
    quat[..., 0] = 1.0
    return SimState(
        mocap=mocap, hand=tcp, hand_vel=z(3), gripper=ones, gripper_vel=z(),
        obj_pos=z(MAX_OBJ, 3), obj_quat=quat, obj_vel=z(MAX_OBJ, 3),
        obj_angvel=z(MAX_OBJ, 3), joint_q=z(MAX_JOINT), joint_v=z(MAX_JOINT),
        attached=z(MAX_OBJ), attach_off=z(MAX_OBJ, 3), unanchored=z(MAX_OBJ),
        hooked=z(MAX_JOINT), hook_off=z(MAX_JOINT), hook_hoff=z(MAX_JOINT, 3),
        pad_force_l=z(), pad_force_r=z(), pad_l=pad_l0, pad_r=pad_r0,
        fixture_pos=z(3),
    )


def env_reset(spec: TaskSpec, rand_vec, goal_visible, gen=None):
    """Reset n slots of one task from their task vectors `rand_vec`
    (n, MAX_RAND). `gen` feeds the rejection rounds of `sample_until`.
    Returns (state, obs)."""
    n = rand_vec.shape[0]
    device = rand_vec.device
    c = spec.consts(device)
    sim = base_sim_state(spec, n, device)
    zeros = torch.zeros
    if not isinstance(goal_visible, torch.Tensor):
        goal_visible = torch.full((n,), float(goal_visible), device=device)
    state = EnvState(
        sim=sim,
        prev_obs=zeros(n, 18, device=device),
        target=zeros(n, 3, device=device),
        hand_init=c.hand_init.expand(n, 3).clone(),
        init_tcp=sim.hand,
        init_left_pad=add_const(sim.hand, (0.0, 0.047, engine.PAD_Z_OFFSET)),
        init_right_pad=add_const(sim.hand, (0.0, -0.047, engine.PAD_Z_OFFSET)),
        obj_init_pos=zeros(n, MAX_OBJ, 3, device=device),
        extras=zeros(n, N_EXTRAS, device=device),
        rand_vec=rand_vec.to(torch.float32),
        path_length=zeros(n, dtype=torch.int32, device=device),
        task_id=torch.full((n,), spec.task_id, dtype=torch.int32, device=device),
        goal_visible=goal_visible.to(torch.float32),
    )
    overrides = spec.reset_fn(spec, state.rand_vec[:, : spec.rand_dim], gen)
    sim_names = {f.name for f in dataclasses.fields(SimState)}
    sim_over = {k: v for k, v in overrides.items() if k in sim_names}
    st_over = {k: v for k, v in overrides.items() if k not in sim_names}
    state = state.replace(sim=sim.replace(**sim_over), **st_over)

    curr = curr_obs18(spec, state)
    state = state.replace(prev_obs=curr)
    obs = assemble_obs(spec, state, curr)
    return state, obs


# ---------------------------------------------------------------------------
# shared reward helpers
# ---------------------------------------------------------------------------

def gripper_caging_reward(spec: TaskSpec, state: EnvState, action, obj_pos,
                          obj_radius: float, pad_success_thresh: float,
                          object_reach_radius: float, xz_thresh: float,
                          desired_gripper_effort: float = 1.0,
                          high_density: bool = False,
                          medium_density: bool = False):
    """The shared grasp-caging reward (ref sawyer_xyz_env.py:721-858)."""
    left_pad, right_pad = engine.pad_positions(state.sim)
    caging_lr = []
    for pad in (left_pad, right_pad):
        pad_to_obj = torch.abs(pad[:, 1] - obj_pos[:, 1])
        pad_to_objinit = torch.abs(pad[:, 1] - state.obj_init_pos[:, 0, 1])
        margin = torch.abs(pad_to_objinit - pad_success_thresh)
        caging_lr.append(reward_utils.tolerance(
            pad_to_obj, bounds=(obj_radius, pad_success_thresh),
            margin=margin, sigmoid="long_tail"))
    caging_y = reward_utils.hamacher_product(caging_lr[0], caging_lr[1])

    tcp = state.sim.hand
    xz = slice(0, 3, 2)  # x and z, as a view (an index list would be copied
    # to the device on every step)
    caging_xz_margin = norm(state.obj_init_pos[:, 0, xz] - state.init_tcp[:, xz])
    caging_xz_margin = caging_xz_margin - xz_thresh
    caging_xz = reward_utils.tolerance(
        norm(tcp[:, xz] - obj_pos[:, xz]), bounds=(0, xz_thresh),
        margin=caging_xz_margin, sigmoid="long_tail")

    gripper_closed = (
        torch.clamp(torch.clamp(action[:, -1], min=0.0),
                    max=desired_gripper_effort)
        / desired_gripper_effort
    )
    caging = reward_utils.hamacher_product(caging_y, caging_xz)
    gripping = torch.where(caging > 0.97, gripper_closed, 0.0)
    caging_and_gripping = reward_utils.hamacher_product(caging, gripping)

    if high_density:
        caging_and_gripping = (caging_and_gripping + caging) / 2
    if medium_density:
        tcp_to_obj = norm(obj_pos - tcp)
        tcp_to_obj_init = norm(state.obj_init_pos[:, 0] - state.init_tcp)
        reach_margin = torch.abs(tcp_to_obj_init - object_reach_radius)
        reach = reward_utils.tolerance(
            tcp_to_obj, bounds=(0, object_reach_radius), margin=reach_margin,
            sigmoid="long_tail")
        caging_and_gripping = (caging_and_gripping + reach) / 2
    return caging_and_gripping


def zero_y(v):
    """(n, 3) with the y column zeroed: the reference's [x, 0, z] vectors."""
    return torch.stack([v[:, 0], torch.zeros_like(v[:, 0]), v[:, 2]], dim=-1)


def gripper_caging_reward_grip(spec: TaskSpec, state: EnvState, action,
                               obj_pos, obj_radius: float,
                               grip_margin_add: float, xz_margin: float,
                               caging_thresh: float = 0.95):
    """The caging variant of push-back, sweep, sweep-into and soccer (ref
    sawyer_sweep_v3.py:150-250): a tighter y-gripping band (bounds
    (obj_radius, obj_radius + grip_margin_add)), and caging AVERAGED with
    gripping instead of their hamacher product. Margins read the live pads."""
    pad_success_margin = 0.05
    grip_success_margin = obj_radius + grip_margin_add
    tcp = state.sim.hand
    left_pad, right_pad = engine.pad_positions(state.sim)
    delta_y_left = left_pad[:, 1] - obj_pos[:, 1]
    delta_y_right = obj_pos[:, 1] - right_pad[:, 1]
    right_margin = torch.abs(torch.abs(obj_pos[:, 1] - right_pad[:, 1])
                             - pad_success_margin)
    left_margin = torch.abs(torch.abs(obj_pos[:, 1] - left_pad[:, 1])
                            - pad_success_margin)

    def tol(x, hi, margin):
        return reward_utils.tolerance(x, bounds=(obj_radius, hi), margin=margin,
                                      sigmoid="long_tail")

    right_caging = tol(delta_y_right, pad_success_margin, right_margin)
    left_caging = tol(delta_y_left, pad_success_margin, left_margin)
    right_gripping = tol(delta_y_right, grip_success_margin, right_margin)
    left_gripping = tol(delta_y_left, grip_success_margin, left_margin)
    y_caging = reward_utils.hamacher_product(right_caging, left_caging)
    y_gripping = reward_utils.hamacher_product(right_gripping, left_gripping)

    tcp_obj_xz = norm(zero_y(tcp) - zero_y(obj_pos))
    xz_margin_v = norm(zero_y(state.obj_init_pos[:, 0]) - zero_y(state.init_tcp)) - xz_margin
    x_z_caging = reward_utils.tolerance(
        tcp_obj_xz, bounds=(0, xz_margin), margin=xz_margin_v,
        sigmoid="long_tail")
    caging = reward_utils.hamacher_product(y_caging, x_z_caging)
    gripping = torch.where(caging > caging_thresh, y_gripping, 0.0)
    return (caging + gripping) / 2


def touching_main_object(state: EnvState):
    """Both pads carry positive force on the object."""
    return (state.sim.pad_force_l > 0) & (state.sim.pad_force_r > 0)
