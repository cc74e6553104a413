"""Legacy "v1" reward family for all 50 tasks, batched over a task's slots.

Counterpart of `metaworld_tpu/rewards/v1.py`. The JAX functions are written
for one env and vmapped; here every function takes a task's whole group of
slots: `state` fields are (n, ...) tensors, `obs` is (n, 39), `action` is
(n, 4), and every EvalOut field is (n,), the slots the JAX code fills with
Python constants (`near_object=1.0`, `grasp_success=0.0`) included.

Every reference env accepts ``reward_function_version="v1"`` (ref
sawyer_xyz_env.py:187) selecting the pre-2020 reward branch of its
``compute_reward`` (the ``else:`` arm, e.g. sawyer_reach_v3.py:150-162,
sawyer_pick_place_v3.py:300-370). This module reimplements that whole family
as functions of ``(spec, state, obs, action)``:

* ``fingerCOM`` in the reference is the midpoint of the two EndEffector
  sites == ``tcp_center`` == ``obs[:3]``. A handful of tasks (button-press,
  coffee-button, button-press-wall, handle-press/-side, handle-pull/-side)
  use the LEFT finger site only; that site sits half a gripper opening in +y
  off the tcp, i.e. ``obs[:3] + (0, 0.05*obs[3], 0)`` (calibrated against the
  reference: residual < 4e-4 m).
* The reference caches reset-time margins (``maxReachDist``/``maxPushDist``/
  ``maxPlacingDist``/...) on the stateful env. Here they are recomputed each
  step from reset-time entries of ``EnvState`` (obj_init_pos/init_tcp/
  target/hand_init).
* The reference's "latches" (``self.pickCompleted``/``reachCompleted``/
  ``placeCompleted``) are all recomputed from scratch every step in the v1
  branch, so the functions here are stateless.
* Info metrics replicate each env's (version-shared) ``evaluate_state``
  applied to the v1 return tuple — including the quirks that zeroed tuple
  slots produce (e.g. ``near_object`` pinned to 1.0 where the gate is
  ``tcp_to_obj <= 0.05`` and the v1 branch returns 0.0 for that slot).

Faithfully preserved reference quirks (do not "fix"):
* button-press-wall gates pressDist on y but its maxDist is measured on z
  (sawyer_button_press_wall_v3.py:124 vs :215).
* coffee-pull's ``reachDistxy`` is the norm of the *point* (obj_x, obj_y,
  init_tcp_z), not of a difference (sawyer_coffee_pull_v3.py:227-229).
* stick-push / stick-pull read ``objPos = obs[6:9]`` — a slice straddling
  the stick z and its quaternion under the v3 obs layout
  (sawyer_stick_push_v3.py:355, stick_pull:300).
* handle-pull's maxDist uses the *body-local* handleStart site z (0.022),
  not its world position (sawyer_handle_pull_v3.py:116-118).
* window-open/close never clamp pullRew to >= 0 (sawyer_window_open_v3.py),
  so their v1 reward can go below -reachDist.
* sweep / sweep-into zero the reach term once the puck has fallen into the
  hole (objPos z < init z - 0.05).

Constants enter as Python numbers (filled on the input's device), so a step
copies nothing from the host; a Python number divides a tensor or is
divided by one through `engine_lanes._x.div`, which rounds once, as XLA does.
Distances are `maths.norm_fma`, rounded as XLA rounds `jnp.linalg.norm`:
the shaping multiplies them by 1000, so one ulp of a distance is ~3e-5 of
reward, more than the reward's own float32 ulp where its terms cancel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from metaworld_tpu_torch.envs.core import add_const
from metaworld_tpu_torch.envs.tasks import common
from metaworld_tpu_torch.envs.tasks.stick_pull_v3 import _inserted
from metaworld_tpu_torch.physics.engine_lanes import _x
from metaworld_tpu_torch.physics.maths import norm_fma as norm

C1, C2, C3 = 1000.0, 0.01, 0.001
H_SCALE = 100.0


def _exp_bonus(d, c):
    """exp(-d^2 / c) for a Python number c."""
    return torch.exp(_x.div(-(d ** 2), c))


def _bonus(d, max_d, c2=C2, c3=C3):
    """1000*(maxDist - d) + 1000*(exp(-d^2/c2) + exp(-d^2/c3)) — the shared
    shaping of every v1 reward (e.g. sawyer_reach_v3.py:156-159)."""
    return 1000.0 * (max_d - d) + C1 * (_exp_bonus(d, c2) + _exp_bonus(d, c3))


def _relu(x):
    return torch.clamp(x, min=0.0)


def _gate(cond, x):
    """x where cond, else 0."""
    return torch.where(cond, x, 0.0)


def _tcp(state):
    """fingerCOM == midpoint of the EndEffector sites == tcp_center — the
    engine's tracked hand point (NOT obs[:3], which is the end-effector
    body ~4.4 cm above the tcp)."""
    return state.sim.hand


def _left_finger(state, obs):
    """leftEndEffector site: tcp + half the gripper opening in +y."""
    hand = state.sim.hand
    return hand + common.const_rows(hand, (0.0, 0.05, 0.0)) * obs[:, 3:4]


def _grip_bonus(action):
    return _x.div(_relu(action[:, -1]), 50.0)


def _xy_dist(a, b):
    return norm(a[:, :2] - b[:, :2])


def _lift_margin(init, height_target, target):
    """|(init_x, init_y, heightTarget) - target| + heightTarget: the pick
    family's maxPlacingDist."""
    return norm(common.vec3(init[:, 0], init[:, 1], height_target)
                - target) + height_target


# ---------------------------------------------------------------- templates


def _press_family(obs, state, *, dist_axis, max_axis, success_radius,
                  grasp_one=False):
    """-reachDist from the left finger + gated press bonus (buttons and
    handles, with different axes/margins)."""
    obj = obs[:, 4:7]
    fc = _left_finger(state, obs)
    press_dist = torch.abs(obj[:, dist_axis] - state.target[:, dist_axis])
    reach_dist = norm(obj - fc)
    max_dist = torch.abs(state.obj_init_pos[:, 0, max_axis]
                         - state.target[:, max_axis])
    press_rew = _gate(reach_dist < 0.05, _bonus(press_dist, max_dist))
    press_rew = _relu(press_rew)
    reward = -reach_dist + press_rew
    return common.eval_out(
        reward=reward,
        success=press_dist <= success_radius,
        near_object=1.0,                       # tuple slot tcp_to_obj == 0.0
        grasp_success=1.0 if grasp_one else 0.0,
        obj_to_target=press_dist,
    )


def _pull_gated(obs, state, *, dist_fn, max_fn, success_radius,
                grasp_one=False, c2=C2, c3=C3, clamp=True):
    """reachRew + pullRew gated on reachCompleted (doors/faucets/lever/
    drawer-open/windows/dial)."""
    obj = obs[:, 4:7]
    fc = _tcp(state)
    pull_dist = dist_fn(obj, state)
    reach_dist = norm(obj - fc)
    pull_rew = _bonus(pull_dist, max_fn(state), c2=c2, c3=c3)
    if clamp:
        pull_rew = _relu(pull_rew)
    pull_rew = _gate(reach_dist < 0.05, pull_rew)
    reward = -reach_dist + pull_rew
    return common.eval_out(
        reward=reward,
        success=pull_dist <= success_radius,
        near_object=1.0,
        grasp_success=1.0 if grasp_one else 0.0,
        obj_to_target=pull_dist,
    )


def _push_simple(obs, state, *, success_radius, three_d=False):
    """reachRew + pushRew gated on reachDist < 0.05, xy distances
    (push/push-wall/push-back/coffee-push/soccer); `three_d` reports and
    judges success on the 3D object-to-target distance."""
    obj = obs[:, 4:7]
    fc = _tcp(state)
    reach_dist = norm(fc - obj)
    push_dist = _xy_dist(obj, state.target)
    max_push = _xy_dist(state.obj_init_pos[:, 0], state.target)
    push_rew = _gate(reach_dist < 0.05, _relu(_bonus(push_dist, max_push)))
    reward = -reach_dist + push_rew
    o2t = norm(obj - state.target) if three_d else push_dist
    return common.eval_out(
        reward=reward,
        success=o2t <= success_radius,
        near_object=1.0,
        obj_to_target=o2t,
    )


def _reach_xyz_gated(action, state, *, obj, xy_thresh=0.05, z_scale=2.0,
                     grip_gate=0.05, z_ref=None):
    """The pick-family reach term: -reachDist when the tcp is over the
    object in xy, else -reachDistxy - z_scale*zRew; grip bonus when close."""
    fc = _tcp(state)
    z_ref = state.init_tcp[:, 2] if z_ref is None else z_ref
    reach_dist = norm(obj - fc)
    reach_xy = _xy_dist(obj, fc)
    z_rew = torch.abs(fc[:, 2] - z_ref)
    reach_rew = torch.where(reach_xy < xy_thresh, -reach_dist,
                            -reach_xy - z_scale * z_rew)
    reach_rew = torch.where(reach_dist < grip_gate,
                            -reach_dist + _grip_bonus(action), reach_rew)
    return reach_rew, reach_dist


def _pick_rew(obj_z, height_target, obj_height, reach_dist, dropped,
              pick_done, *, reach_gate=0.1, z_offset=0.0):
    """hScale ladder shared by the pick family (e.g.
    sawyer_pick_place_v3.py:330-345)."""
    full = H_SCALE * (height_target + z_offset)
    partial = H_SCALE * (_x.minimum(height_target, obj_z) + z_offset)
    lifting = (reach_dist < reach_gate) & (obj_z > obj_height + 0.005)
    return torch.where(pick_done & ~dropped, full, _gate(lifting, partial))


def _dropped(obj_z, obj_height, placing_dist, reach_dist):
    return ((obj_z < obj_height + 0.005) & (placing_dist > 0.02)
            & (reach_dist > 0.02))


def _pick_place_family(obs, action, state, *, lift_thresh):
    """The standard v1 pick&place template (pick-place, pick-place-wall,
    basketball, shelf-place)."""
    obj = obs[:, 4:7]
    obj_height = state.obj_init_pos[:, 0, 2]
    height_target = obj_height + lift_thresh
    placing_dist = norm(obj - state.target)
    reach_rew, reach_dist = _reach_xyz_gated(action, state, obj=obj)
    pick_done = obj[:, 2] >= height_target - 0.01
    dropped = _dropped(obj[:, 2], obj_height, placing_dist, reach_dist)
    pick_rew = _pick_rew(obj[:, 2], height_target, obj_height, reach_dist,
                         dropped, pick_done)
    max_placing = _lift_margin(state.obj_init_pos[:, 0], height_target,
                               state.target)
    cond = pick_done & (reach_dist < 0.1) & ~dropped
    place_rew = _gate(cond, _relu(_bonus(placing_dist, max_placing)))
    reward = reach_rew + pick_rew + place_rew
    return reward, placing_dist, reach_dist


# ------------------------------------------------------------ per-task fns
# Signature matches TaskSpec.reward_fn: (spec, state, obs, action) -> EvalOut


# the reference's settled tcp after _reset_hand: hand_init + this constant
# (measured; our own settle differs by ~3 mm, which would bias the reach
# margin by 1000x that)
_REF_SETTLE_OFF = (0.0044, 0.0015, -0.0498)


def _ref_init_tcp(state):
    return add_const(state.hand_init, _REF_SETTLE_OFF)


def v1_reach(spec, state, obs, action):
    """ref sawyer_reach_v3.py:150-162 (v1 branch)."""
    reach_dist = norm(_tcp(state) - state.target)
    max_reach = norm(_ref_init_tcp(state) - state.target)
    reward = _relu(_bonus(reach_dist, max_reach))
    return common.eval_out(
        reward=reward, success=reach_dist <= 0.05,
        near_object=reach_dist, grasp_success=1.0, grasp_reward=reach_dist,
        obj_to_target=reach_dist)


def v1_reach_wall(spec, state, obs, action):
    """ref sawyer_reach_wall_v3.py (v1): same formula; evaluate_state maps
    the tuple differently (near/grasp zeroed)."""
    reach_dist = norm(_tcp(state) - state.target)
    max_reach = norm(_ref_init_tcp(state) - state.target)
    reward = _relu(_bonus(reach_dist, max_reach))
    return common.eval_out(
        reward=reward, success=reach_dist <= 0.05, obj_to_target=reach_dist)


def v1_push(spec, state, obs, action):
    """ref sawyer_push_v3.py (v1)."""
    return _push_simple(obs, state, success_radius=0.05)


def v1_push_wall(spec, state, obs, action):
    return _push_simple(obs, state, success_radius=0.07)


def v1_push_back(spec, state, obs, action):
    return _push_simple(obs, state, success_radius=0.07)


def v1_coffee_push(spec, state, obs, action):
    """ref sawyer_coffee_push_v3.py (v1): obj_to_target reported in 3D."""
    return _push_simple(obs, state, success_radius=0.07, three_d=True)


def v1_soccer(spec, state, obs, action):
    return _push_simple(obs, state, success_radius=0.07)


def v1_coffee_pull(spec, state, obs, action):
    """ref sawyer_coffee_pull_v3.py:220-250 (v1). NB `reachDistxy` is the
    norm of the point (obj_x, obj_y, init_tcp_z) — preserved as-is."""
    obj = obs[:, 4:7]
    fc = _tcp(state)
    reach_dist = norm(fc - obj)
    pull_dist = _xy_dist(obj, state.target)
    weird_xy = norm(common.vec3(obj[:, 0], obj[:, 1], state.init_tcp[:, 2]))
    reach_rew = torch.where(
        weird_xy < 0.05,
        -reach_dist + 0.1 + _gate(reach_dist < 0.05, _grip_bonus(action)),
        -weird_xy)
    max_pull = _xy_dist(state.obj_init_pos[:, 0], state.target)
    pull_rew = _gate(reach_dist < 0.05, _relu(_bonus(pull_dist, max_pull)))
    reward = reach_rew + pull_rew
    o2t = norm(obj - state.target)
    return common.eval_out(
        reward=reward, success=o2t <= 0.07, near_object=1.0, obj_to_target=o2t)


def _sweep_family(obs, state, fell):
    """sweep / sweep-into: the reach term and the push distance are zeroed
    once the puck has fallen (`fell`)."""
    obj = obs[:, 4:7]
    reach_dist = norm(_tcp(state) - obj)
    push_dist = _xy_dist(obj, state.target)
    reach_rew = torch.where(fell, 0.0, -reach_dist)
    push_dist = torch.where(fell, 0.0, push_dist)
    max_push = _xy_dist(state.obj_init_pos[:, 0], state.target)
    push_rew = _gate(reach_dist < 0.05, _relu(_bonus(push_dist, max_push)))
    reward = reach_rew + push_rew
    return common.eval_out(
        reward=reward, success=push_dist <= 0.05, near_object=1.0,
        obj_to_target=push_dist)


def v1_sweep_into(spec, state, obs, action):
    """ref sawyer_sweep_into_goal_v3.py (v1): reach term zeroed once the
    puck is in the hole (z < init z - 0.05, 0.4 < y < 1.0)."""
    obj = obs[:, 4:7]
    in_hole = ((obj[:, 2] < state.obj_init_pos[:, 0, 2] - 0.05)
               & (obj[:, 1] > 0.4) & (obj[:, 1] < 1.0))
    return _sweep_family(obs, state, in_hole)


def v1_sweep(spec, state, obs, action):
    """ref sawyer_sweep_v3.py (v1): off-table check has no y bounds."""
    fell = obs[:, 6] < state.obj_init_pos[:, 0, 2] - 0.05
    return _sweep_family(obs, state, fell)


def v1_hand_insert(spec, state, obs, action):
    """ref sawyer_hand_insert_v3.py (v1): pure reaching task on the tcp —
    xy reach plus a gated z-descent bonus; margin |hand_init_z - target_z|."""
    fc = _tcp(state)
    reach_xy = _xy_dist(fc, state.target)
    reach_z = torch.abs(fc[:, 2] - state.target[:, 2])
    max_reach = torch.abs(state.hand_init[:, 2] - state.target[:, 2])
    near = _gate(reach_xy < 0.05, _bonus(reach_z, max_reach))
    reward = -reach_xy + _relu(near)
    o2t = norm(state.obj_init_pos[:, 0] - state.target)
    return common.eval_out(
        reward=reward, success=o2t <= 0.05, near_object=1.0, obj_to_target=o2t)


# --- buttons ---------------------------------------------------------------

def v1_button_press_topdown(spec, state, obs, action):
    """ref sawyer_button_press_topdown_v3.py:190-215 (v1)."""
    obj = obs[:, 4:7]
    press_dist = torch.abs(obj[:, 2] - state.target[:, 2])
    reach_dist = norm(obj - _tcp(state))
    max_dist = torch.abs(state.obj_init_pos[:, 0, 2] - state.target[:, 2])
    press_rew = _relu(_gate(reach_dist < 0.05, _bonus(press_dist, max_dist)))
    reward = -reach_dist + press_rew
    return common.eval_out(
        reward=reward, success=press_dist <= 0.024, near_object=1.0,
        obj_to_target=press_dist)


v1_button_press_topdown_wall = v1_button_press_topdown


def v1_button_press(spec, state, obs, action):
    """ref sawyer_button_press_v3.py (v1): left finger, y axis."""
    return _press_family(obs, state, dist_axis=1,
                         max_axis=1, success_radius=0.02)


def v1_button_press_wall(spec, state, obs, action):
    """ref sawyer_button_press_wall_v3.py (v1): pressDist on y but maxDist
    measured on z (reference quirk)."""
    return _press_family(obs, state, dist_axis=1,
                         max_axis=2, success_radius=0.03)


def v1_coffee_button(spec, state, obs, action):
    return _press_family(obs, state, dist_axis=1,
                         max_axis=1, success_radius=0.02)


# --- handles ---------------------------------------------------------------

def v1_handle_press(spec, state, obs, action):
    """ref sawyer_handle_press_v3.py (v1): left finger, z axis."""
    return _press_family(obs, state, dist_axis=2,
                         max_axis=2, success_radius=0.02, grasp_one=True)


def v1_handle_press_side(spec, state, obs, action):
    return _press_family(obs, state, dist_axis=2,
                         max_axis=2, success_radius=0.02, grasp_one=True)


def _v1_handle_pull(obs, state, *, max_dist, success_radius):
    obj = obs[:, 4:7]
    press_dist = torch.abs(obj[:, 2] - state.target[:, 2])
    reach_dist = norm(obj - _left_finger(state, obs))
    press_rew = _relu(_gate(reach_dist < 0.05, _bonus(press_dist, max_dist)))
    reward = -reach_dist + press_rew
    return common.eval_out(
        reward=reward, success=press_dist <= success_radius, near_object=1.0,
        obj_to_target=press_dist)


def v1_handle_pull(spec, state, obs, action):
    """ref sawyer_handle_pull_v3.py (v1): maxDist from the BODY-LOCAL
    handleStart z (0.022, handle_press.xml:11) — reference quirk."""
    return _v1_handle_pull(obs, state,
                           max_dist=torch.abs(0.022 - state.target[:, 2]),
                           success_radius=0.05)


def v1_handle_pull_side(spec, state, obs, action):
    # the handleStart site sits 0.022 above the observed handle point, and
    # the reference margin is site-based (sawyer_handle_pull_side_v3.py:116)
    return _v1_handle_pull(
        obs, state,
        max_dist=torch.abs(state.obj_init_pos[:, 0, 2] + 0.022
                           - state.target[:, 2]),
        success_radius=0.08)


# --- fixtures: doors / faucets / drawers / windows / dial / lever ---------

def _xy_pull(obs, state, init_xy):
    """-reachDist + the xy pull bonus gated on reachDist < 0.05, margin
    |init_xy - target_xy| (doors, plate slides). Returns (reward,
    pull_dist)."""
    obj = obs[:, 4:7]
    pull_dist = _xy_dist(obj, state.target)
    reach_dist = norm(obj - _tcp(state))
    max_pull = _xy_dist(init_xy, state.target)
    pull_rew = _gate(reach_dist < 0.05, _relu(_bonus(pull_dist, max_pull)))
    return -reach_dist + pull_rew, pull_dist


def v1_door_open(spec, state, obs, action):
    """ref sawyer_door_v3.py:200-230 (v1): xy pull gated on reach."""
    # the reference margin is the handle geom xpos at reset, which matches
    # our handle obs init (measured: |delta| < 3e-4)
    reward, _ = _xy_pull(obs, state, state.obj_init_pos[:, 0, :2])
    return common.eval_out(
        reward=reward,
        success=torch.abs(obs[:, 4] - state.target[:, 0]) <= 0.08)


def v1_door_close(spec, state, obs, action):
    # obj_init_pos is the DOOR BODY (v2 margins need it); the v1 margin is
    # the fresh handle-geom read at reset = body + pivot + open-pose arm
    handle0 = add_const(state.obj_init_pos[:, 0, :2], (-0.2922, -0.4757))
    reward, pull_dist = _xy_pull(obs, state, handle0)
    return common.eval_out(
        reward=reward, success=pull_dist <= 0.08,
        grasp_success=1.0, grasp_reward=1.0, obj_to_target=pull_dist)


def _dist3(o, s):
    return norm(o - s.target)


def _margin3(s):
    return norm(s.target - s.obj_init_pos[:, 0])


def v1_door_lock(spec, state, obs, action):
    return _pull_gated(obs, state, dist_fn=_dist3, max_fn=_margin3,
                       success_radius=0.02)


v1_door_unlock = v1_door_lock


def v1_faucet_open(spec, state, obs, action):
    return _pull_gated(obs, state, dist_fn=_dist3, max_fn=_margin3,
                       success_radius=0.07, grasp_one=True)


v1_faucet_close = v1_faucet_open

# ref obj_init_pos is the lever BASE body; target = base + (0.12, 0, 0.45),
# so the margin is constant: |(0.12, 0, 0.45)| in float32
_LEVER_MARGIN = float(np.sqrt(np.float32(0.12) * np.float32(0.12)
                              + np.float32(0.0) * np.float32(0.0)
                              + np.float32(0.45) * np.float32(0.45),
                              dtype=np.float32))


def v1_lever_pull(spec, state, obs, action):
    """ref sawyer_lever_pull_v3.py (v1); evaluate_state compares the tuple's
    lever_error slot (= pullDist here) against pi/24."""
    return _pull_gated(obs, state, dist_fn=_dist3,
                       max_fn=lambda s: _LEVER_MARGIN,
                       success_radius=math.pi / 24)


def _dist_axis(k):
    return lambda o, s: torch.abs(o[:, k] - s.target[:, k])


def v1_dial_turn(spec, state, obs, action):
    """ref sawyer_dial_turn_v3.py (v1): y-distance, sharper exps
    (c2=1e-3, c3=1e-4)."""
    return _pull_gated(
        obs, state, dist_fn=_dist_axis(1),
        max_fn=lambda s: torch.abs(s.target[:, 1] - s.obj_init_pos[:, 0, 1]),
        success_radius=0.07, grasp_one=True, c2=0.001, c3=0.0001)


def v1_drawer_open(spec, state, obs, action):
    """ref sawyer_drawer_open_v3.py (v1): fixed maxDist=0.2."""
    return _pull_gated(obs, state, dist_fn=_dist_axis(1),
                       max_fn=lambda s: 0.2, success_radius=0.03)


def v1_drawer_close(spec, state, obs, action):
    """ref sawyer_drawer_close_v3.py (v1): fixed maxDist=0.15; success uses
    TARGET_RADIUS(0.05)+0.015."""
    return _pull_gated(obs, state, dist_fn=_dist_axis(1),
                       max_fn=lambda s: 0.15, success_radius=0.065,
                       grasp_one=True)


def v1_window_open(spec, state, obs, action):
    """ref sawyer_window_open_v3.py (v1): x-distance, fixed maxDist=0.2,
    pullRew NOT clamped to >= 0 (reference quirk)."""
    return _pull_gated(obs, state, dist_fn=_dist_axis(0),
                       max_fn=lambda s: 0.2, success_radius=0.05,
                       grasp_one=True, clamp=False)


v1_window_close = v1_window_open


# --- plate slides ----------------------------------------------------------

def v1_plate_slide(spec, state, obs, action):
    """ref sawyer_plate_slide_v3.py (v1) — identical across three of the
    four plate-slide variants."""
    reward, pull_dist = _xy_pull(obs, state, state.obj_init_pos[:, 0, :2])
    return common.eval_out(
        reward=reward, success=pull_dist <= 0.07, near_object=1.0,
        obj_to_target=pull_dist)


def v1_plate_slide_back_side(spec, state, obs, action):
    """plate-slide-back-side reads the puck geom BEFORE mj_forward
    (sawyer_plate_slide_back_side_v3.py:141), i.e. the stale XML pose 0.1 m
    +x of the randomized body — its maxDist margin is off by exactly that."""
    stale_init = add_const(state.obj_init_pos[:, 0, :2], (0.1, 0.0))
    reward, pull_dist = _xy_pull(obs, state, stale_init)
    return common.eval_out(
        reward=reward, success=pull_dist <= 0.07, near_object=1.0,
        obj_to_target=pull_dist)


# --- pick & place family ---------------------------------------------------

def _pick_place_out(success_radius, lift_thresh):
    def fn(spec, state, obs, action):
        reward, placing_dist, _ = _pick_place_family(
            obs, action, state, lift_thresh=lift_thresh)
        return common.eval_out(
            reward=reward, success=placing_dist <= success_radius,
            near_object=1.0, obj_to_target=placing_dist)

    return fn


# ref sawyer_pick_place_v3.py:300-370 (v1)
v1_pick_place = _pick_place_out(0.07, lift_thresh=0.04)
v1_pick_place_wall = v1_pick_place
# ref sawyer_basketball_v3.py (v1): liftThresh=0.3, success radius 0.08
v1_basketball = _pick_place_out(0.08, lift_thresh=0.3)
v1_shelf_place = _pick_place_out(0.07, lift_thresh=0.04)


def v1_box_close(spec, state, obs, action):
    """ref sawyer_box_close_v3.py (v1): liftThresh=0.12; success on the full
    3D lid-to-target distance < 0.08; info mostly zeroed (5-tuple).

    The reference objHeight reads the BoxHandleGeom world z (a constant
    0.1473, ~13 cm above the lid obs point), which keeps the v1 pick ladder
    from ever firing on scripted play — preserved as-is."""
    obj = obs[:, 4:7]
    obj_height = 0.1473
    height_target = obj_height + 0.12
    placing_dist = norm(obj - state.target)
    reach_rew, reach_dist = _reach_xyz_gated(action, state, obj=obj)
    pick_done = obj[:, 2] >= height_target - 0.01
    dropped = _dropped(obj[:, 2], obj_height, placing_dist, reach_dist)
    pick_rew = _pick_rew(obj[:, 2], height_target, obj_height, reach_dist,
                         dropped, pick_done)
    max_placing = _lift_margin(state.obj_init_pos[:, 0], height_target,
                               state.target)
    cond = pick_done & (reach_dist < 0.1) & ~dropped
    place_rew = _gate(cond, _relu(_bonus(placing_dist, max_placing)))
    reward = reach_rew + pick_rew + place_rew
    return common.eval_out(reward=reward, success=placing_dist < 0.08)


def v1_pick_out_of_hole(spec, state, obs, action):
    """ref sawyer_pick_out_of_hole_v3.py (v1): liftThresh=0.11, pickRew
    ladder offset by (-objHeight + 0.02)."""
    obj = obs[:, 4:7]
    obj_height = state.obj_init_pos[:, 0, 2]
    height_target = obj_height + 0.11
    placing_dist = norm(obj - state.target)
    reach_rew, reach_dist = _reach_xyz_gated(action, state, obj=obj)
    pick_done = obj[:, 2] >= height_target - 0.01
    dropped = _dropped(obj[:, 2], obj_height, placing_dist, reach_dist)
    pick_rew = _pick_rew(obj[:, 2], height_target, obj_height, reach_dist,
                         dropped, pick_done, z_offset=-obj_height + 0.02)
    max_placing = _lift_margin(state.obj_init_pos[:, 0], height_target,
                               state.target)
    cond = pick_done & (reach_dist < 0.1) & ~dropped
    place_rew = _gate(cond, _relu(_bonus(placing_dist, max_placing)))
    reward = reach_rew + pick_rew + place_rew
    return common.eval_out(
        reward=reward, success=placing_dist <= 0.07, near_object=1.0,
        obj_to_target=placing_dist)


def v1_bin_picking(spec, state, obs, action):
    """ref sawyer_bin_picking_v3.py:260-330 (v1): xy placing distance,
    placeCompleted short-circuits to -200*grip + placeRew."""
    obj = obs[:, 4:7]
    obj_height = state.obj_init_pos[:, 0, 2]
    height_target = obj_height + 0.1
    placing_dist = _xy_dist(obj, state.target)
    reach_rew, reach_dist = _reach_xyz_gated(
        action, state, obj=obj, xy_thresh=0.06, z_scale=1.0)
    pick_done = obj[:, 2] >= height_target - 0.01
    dropped = _dropped(obj[:, 2], obj_height, placing_dist, reach_dist)
    near_goal_xy = ((torch.abs(obj[:, 0] - state.target[:, 0]) < 0.05)
                    & (torch.abs(obj[:, 1] - state.target[:, 1]) < 0.05))
    place_completed = near_goal_xy & (obj[:, 2] < obj_height + 0.05)
    lifting = (reach_dist < 0.1) & (obj[:, 2] > obj_height + 0.005)
    pick_rew = torch.where(
        place_completed | (pick_done & ~dropped), H_SCALE * height_target,
        _gate(lifting, H_SCALE * torch.minimum(height_target, obj[:, 2])))
    max_placing = (_xy_dist(state.obj_init_pos[:, 0], state.target)
                   + height_target)
    place_base = _relu(_bonus(placing_dist, max_placing))
    release = -200.0 * action[:, -1] + place_base
    cond = pick_done & (reach_dist < 0.1) & ~dropped
    place_rew = _gate(cond, torch.where(near_goal_xy, release, place_base))
    full = reach_rew + pick_rew + place_rew
    reward = torch.where(place_completed, release, full)
    return common.eval_out(
        reward=reward, success=placing_dist <= 0.05, obj_to_target=placing_dist)


def v1_peg_insert_side(spec, state, obs, action):
    """ref sawyer_peg_insertion_side_v3.py (v1): liftThresh=0.11, z_scale=1;
    place bonus switches to the peg-HEAD distance until the head is within
    5 cm of the goal. pegHead = obs + (-0.13, 0, -0.01) (site offset)."""
    obj = obs[:, 4:7]
    peg_head = add_const(obj, (-0.13, 0.0, -0.01))
    peg_com_init = state.obj_init_pos[:, 0]   # stored as the body com
    obj_height = peg_com_init[:, 2]
    height_target = obj_height + 0.11
    placing_dist = norm(obj - state.target)
    placing_head = norm(peg_head - state.target)
    reach_rew, reach_dist = _reach_xyz_gated(
        action, state, obj=obj, z_scale=1.0)
    pick_done = obj[:, 2] >= height_target - 0.01
    dropped = _dropped(obj[:, 2], obj_height, placing_dist, reach_dist)
    pick_rew = _pick_rew(obj[:, 2], height_target, obj_height, reach_dist,
                         dropped, pick_done)
    max_placing = _lift_margin(peg_com_init, height_target, state.target)
    cond = pick_done & (reach_dist < 0.1) & ~dropped
    place_rew = torch.where(
        placing_head <= 0.05,
        _bonus(placing_dist, max_placing),
        _bonus(placing_head, max_placing))
    place_rew = _gate(cond, _relu(place_rew))
    reward = reach_rew + pick_rew + place_rew
    return common.eval_out(
        reward=reward, success=placing_dist <= 0.07, near_object=1.0,
        obj_to_target=placing_dist)


def v1_peg_unplug_side(spec, state, obs, action):
    """ref sawyer_peg_unplug_side_v3.py (v1): xy placing distance, zRew
    referenced to hand_init (not init_tcp)."""
    obj = obs[:, 4:7]
    placing_dist = _xy_dist(obj, state.target)
    reach_rew, reach_dist = _reach_xyz_gated(
        action, state, obj=obj, z_ref=state.hand_init[:, 2])
    max_placing = norm(state.target - state.obj_init_pos[:, 0])
    place_rew = _gate(reach_dist < 0.05,
                      _relu(_bonus(placing_dist, max_placing)))
    reward = reach_rew + place_rew
    return common.eval_out(
        reward=reward, success=placing_dist <= 0.07, near_object=1.0,
        obj_to_target=placing_dist)


# --- tool tasks ------------------------------------------------------------

def v1_assembly(spec, state, obs, action):
    """ref sawyer_assembly_peg_v3.py:270-335 (v1). graspPos = wrench handle
    (obs), objPos = RoundNut body com = obs + (-0.13, 0, 0); xy placing
    distance + a final z-descent term once over the peg."""
    grasp = obs[:, 4:7]
    nut = state.sim.obj_pos[:, 0]     # RoundNut body com — exact in our engine
    obj_height = state.obj_init_pos[:, 0, 2]
    height_target = obj_height + 0.1
    placing_dist = _xy_dist(nut, state.target)
    placing_final = torch.abs(nut[:, 2] - obj_height)
    reach_rew, reach_dist = _reach_xyz_gated(
        action, state, obj=grasp, xy_thresh=0.04, z_scale=1.0,
        grip_gate=0.04)
    pick_done = (nut[:, 2] >= height_target - 0.01) & (reach_dist < 0.03)
    dropped = _dropped(nut[:, 2], obj_height, placing_dist, reach_dist)
    place_completed = ((torch.abs(nut[:, 0] - state.target[:, 0]) < 0.03)
                       & (torch.abs(nut[:, 1] - state.target[:, 1]) < 0.03))
    lifting = (reach_dist < 0.04) & (nut[:, 2] > obj_height + 0.005)
    pick_rew = torch.where(
        place_completed | (pick_done & ~dropped), H_SCALE * height_target,
        _gate(lifting, H_SCALE * torch.minimum(height_target, nut[:, 2])))
    # obj_init_pos is stored as the nut COM already
    max_placing = _lift_margin(state.obj_init_pos[:, 0], height_target,
                               state.target)
    place_rew = _bonus(placing_dist, max_placing)
    place_rew = place_rew + _gate(
        place_completed,
        2000.0 * (height_target - placing_final)
        + 2000.0 * (_exp_bonus(placing_final, 0.003)
                    + _exp_bonus(placing_final, 0.0003)))
    place_rew = _relu(place_rew)
    cond = place_completed | (pick_done & (reach_dist < 0.04) & ~dropped)
    place_rew = _gate(cond, place_rew)
    reward = reach_rew + pick_rew + place_rew
    success = place_completed & (placing_final <= 0.04)
    return common.eval_out(reward=reward, success=success)


def v1_disassemble(spec, state, obs, action):
    """ref sawyer_disassemble_peg_v3.py:230-305 (v1). objPos = graspPos =
    obs; once the nut com clears the peg in xy, reach is zeroed and pickRew
    is pinned to heightTarget*100."""
    obj = obs[:, 4:7]
    nut = state.sim.obj_pos[:, 0]     # RoundNut body com — exact in our engine
    obj_height = state.obj_init_pos[:, 0, 2]
    height_target = obj_height + 0.05
    placing_dist = norm(obj - state.target)
    reach_rew, reach_dist = _reach_xyz_gated(
        action, state, obj=obj, xy_thresh=0.04, grip_gate=0.04)
    pick_done = (obj[:, 2] >= height_target - 0.01) & (reach_dist < 0.04)
    dropped = _dropped(obj[:, 2], obj_height, placing_dist, reach_dist)
    lifting = (reach_dist < 0.04) & (obj[:, 2] > obj_height + 0.005)
    pick_rew = torch.where(
        pick_done & ~dropped, H_SCALE * height_target,
        _gate(lifting, H_SCALE * torch.minimum(height_target, obj[:, 2])))
    nut_init = state.obj_init_pos[:, 0]   # stored as the nut COM already
    max_placing = _lift_margin(nut_init, height_target, state.target)
    place_rew = _relu(_bonus(placing_dist, max_placing))
    cond = pick_done & (reach_dist < 0.03) & ~dropped
    place_rew = _gate(cond, place_rew)
    # peg body sits at the nut's initial xy (the nut starts threaded on it)
    cleared = ((torch.abs(nut[:, 0] - nut_init[:, 0]) > 0.05)
               | (torch.abs(nut[:, 1] - nut_init[:, 1]) > 0.05))
    reach_rew = torch.where(cleared, 0.0, reach_rew)
    pick_rew = torch.where(cleared, height_target * 100.0, pick_rew)
    reward = reach_rew + pick_rew + place_rew
    return common.eval_out(reward=reward,
                           success=obs[:, 6] > state.target[:, 2])


def v1_hammer(spec, state, obs, action):
    """ref sawyer_hammer_v3.py:232-280 (v1). objPos = nailHead site (our
    obs[11:14] IS the nail head); hammerHead = the HammerHead geom at local
    (0.16, 0, 0) rotated by the live hammer body quat obs[7:11] (wxyz) —
    bit-exact against the reference trace's recorded geom xpos."""
    hammer = obs[:, 4:7]
    hammer_head = hammer + common.rotate_const(obs[:, 7:11], (0.16, 0.0, 0.0))
    nail = obs[:, 11:14]
    hammer_height = state.obj_init_pos[:, 0, 2]
    height_target = hammer_height + 0.09
    hammer_dist = norm(nail - hammer_head)
    screw_dist = torch.abs(nail[:, 1] - state.target[:, 1])
    reach_dist = norm(hammer - _tcp(state))
    reach_rew = torch.where(reach_dist < 0.05,
                            -reach_dist + _grip_bonus(action), -reach_dist)
    pick_done = hammer[:, 2] >= height_target - 0.01
    dropped = _dropped(hammer[:, 2], hammer_height, hammer_dist, reach_dist)
    pick_rew = _pick_rew(hammer[:, 2], height_target, hammer_height,
                         reach_dist, dropped, pick_done)
    # maxHammerDist (ref :125-139): the reference subtracts obj_init_pos
    # (the HAMMER's own init, not the nail), so the norm collapses to the
    # pure lift height: (heightTarget - hammer_z0) + heightTarget
    # + |hammer_y0 - target_y|
    max_hammer = (
        (height_target - state.obj_init_pos[:, 0, 2]) + height_target
        + torch.abs(state.obj_init_pos[:, 0, 1] - state.target[:, 1])
    )
    d = hammer_dist + screw_dist
    cond = pick_done & (reach_dist < 0.1) & ~dropped
    hammer_rew = _gate(cond, _relu(
        1000.0 * (max_hammer - hammer_dist - screw_dist)
        + C1 * (_exp_bonus(d, C2) + _exp_bonus(d, C3))))
    reward = reach_rew + pick_rew + hammer_rew
    return common.eval_out(reward=reward,
                           success=state.sim.joint_q[:, 0] > 0.09)


def _v1_stick(obs, action, state, *, second_bonus_c=(C2, C3)):
    """Shared stick-push/stick-pull v1 body (ref sawyer_stick_push_v3.py:
    350-410). `objPos = obs[6:9]` — the reference reads a stale v2-era obs
    slice that straddles stick z and quat; preserved verbatim."""
    stick = obs[:, 4:7]
    objp = obs[:, 6:9]
    stick_init = state.extras[:, :3]
    stick_height = stick_init[:, 2]
    height_target = stick_height + 0.04
    push_dist = _xy_dist(objp, state.target)
    place_dist = norm(objp - stick)
    reach_dist = norm(stick - _tcp(state))
    reach_rew = torch.where(reach_dist < 0.05,
                            -reach_dist + _grip_bonus(action), -reach_dist)
    pick_done = stick[:, 2] >= height_target - 0.01
    dropped = _dropped(stick[:, 2], stick_height, push_dist, reach_dist)
    pick_rew = _pick_rew(stick[:, 2], height_target, stick_height, reach_dist,
                         dropped, pick_done)
    cont_init = state.obj_init_pos[:, 0]   # the fixed container origin
    max_place = _lift_margin(cont_init, height_target, stick_init)
    max_push = _xy_dist(cont_init, state.target)
    c5, c6 = second_bonus_c
    second = 1000.0 * (max_push - push_dist) + 2000.0 * (
        _exp_bonus(push_dist, c5) + _exp_bonus(push_dist, c6))
    push_rew = _bonus(place_dist, max_place) + _gate(place_dist < 0.05, second)
    cond = pick_done & (reach_dist < 0.1) & ~dropped
    push_rew = _gate(cond, _relu(push_rew))
    reward = reach_rew + pick_rew + push_rew
    return reward, push_dist


def v1_stick_push(spec, state, obs, action):
    """v1 stick-push; info success is `grasp_success and success` with the
    tuple's grasp slot zeroed — always 0.0 (reference quirk)."""
    reward, push_dist = _v1_stick(obs, action, state,
                                  second_bonus_c=(0.001, 0.0001))
    return common.eval_out(
        reward=reward, success=0.0, near_object=1.0, obj_to_target=push_dist)


def v1_stick_pull(spec, state, obs, action):
    """v1 stick-pull; success computed from the live obs (handle in the
    target zone AND the stick inserted), same as v2."""
    reward, pull_dist = _v1_stick(obs, action, state)
    handle = obs[:, 11:14]
    end_of_stick = add_const(obs[:, 4:7], (0.13, 0.0, 0.0))
    success = ((norm(handle - state.target) <= 0.12)
               & _inserted(end_of_stick, handle))
    return common.eval_out(
        reward=reward, success=success, near_object=1.0,
        obj_to_target=pull_dist)


V1_REWARDS = {
    "assembly-v3": v1_assembly,
    "basketball-v3": v1_basketball,
    "bin-picking-v3": v1_bin_picking,
    "box-close-v3": v1_box_close,
    "button-press-topdown-v3": v1_button_press_topdown,
    "button-press-topdown-wall-v3": v1_button_press_topdown_wall,
    "button-press-v3": v1_button_press,
    "button-press-wall-v3": v1_button_press_wall,
    "coffee-button-v3": v1_coffee_button,
    "coffee-pull-v3": v1_coffee_pull,
    "coffee-push-v3": v1_coffee_push,
    "dial-turn-v3": v1_dial_turn,
    "disassemble-v3": v1_disassemble,
    "door-close-v3": v1_door_close,
    "door-lock-v3": v1_door_lock,
    "door-open-v3": v1_door_open,
    "door-unlock-v3": v1_door_unlock,
    "hand-insert-v3": v1_hand_insert,
    "drawer-close-v3": v1_drawer_close,
    "drawer-open-v3": v1_drawer_open,
    "faucet-open-v3": v1_faucet_open,
    "faucet-close-v3": v1_faucet_close,
    "hammer-v3": v1_hammer,
    "handle-press-side-v3": v1_handle_press_side,
    "handle-press-v3": v1_handle_press,
    "handle-pull-side-v3": v1_handle_pull_side,
    "handle-pull-v3": v1_handle_pull,
    "lever-pull-v3": v1_lever_pull,
    "pick-place-wall-v3": v1_pick_place_wall,
    "pick-out-of-hole-v3": v1_pick_out_of_hole,
    "pick-place-v3": v1_pick_place,
    "plate-slide-v3": v1_plate_slide,
    "plate-slide-side-v3": v1_plate_slide,
    "plate-slide-back-v3": v1_plate_slide,
    "plate-slide-back-side-v3": v1_plate_slide_back_side,
    "peg-insert-side-v3": v1_peg_insert_side,
    "peg-unplug-side-v3": v1_peg_unplug_side,
    "soccer-v3": v1_soccer,
    "stick-push-v3": v1_stick_push,
    "stick-pull-v3": v1_stick_pull,
    "push-v3": v1_push,
    "push-wall-v3": v1_push_wall,
    "push-back-v3": v1_push_back,
    "reach-v3": v1_reach,
    "reach-wall-v3": v1_reach_wall,
    "shelf-place-v3": v1_shelf_place,
    "sweep-into-v3": v1_sweep_into,
    "sweep-v3": v1_sweep,
    "window-open-v3": v1_window_open,
    "window-close-v3": v1_window_close,
}
