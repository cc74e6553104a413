"""Lane-oriented physics step in PyTorch: the plain version of the kernel.

Counterpart of `metaworld_tpu/physics/engine_lanes.py`, translated line for
line: every quantity is a flat `(N,)` lane tensor, 3-vectors are tuples of
three lanes, per-object/joint/static quantities are Python lists, and every
loop over objects, joints and boxes is unrolled. The substep is elementwise
over envs, which is what the CUDA kernel (`csrc/substep.cuh`) runs with one
thread per env; this module is that kernel's reference on the card and the
physics the CPU runs.

Numerics follow the JAX module: float32 throughout, the polynomial `_atan2`,
NaN-propagating maximum/minimum/clip (the non-finite guard of the fused
engine depends on a NaN reaching the state), and `sign` that is 0 at 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from metaworld_tpu_torch.physics import engine
from metaworld_tpu_torch.physics.engine import (
    _F_DAMP,
    _F_KP,
    _F_MASS,
    _GRASP_XZ_TOL,
    _GRASP_Z_SPAN,
    _GRAVITY,
    _HAND_KNUCKLE_R,
    _HAND_TIP_R,
    _HOOK_SLIP,
    _K_SLIDE_LIM,
    _D_SLIDE_LIM,
    _L_RANGE,
    _MU_HAND,
    _MU_TABLE,
    _SQUEEZE_CREEP,
    _PAD_TIP_BEVEL,
    _R_RANGE,
    _WELD_K,
    HAND_VMAX,
    HAND_W,
    HAND_ZETA,
    PAD_GAP_INSET,
    PAD_Z_OFFSET,
)
from metaworld_tpu_torch.types import (
    ACTION_SCALE,
    FRAME_SKIP,
    GRIPPER_FULL_OPEN,
    MAX_JOINT,
    MAX_OBJ,
    MAX_STATIC,
    SIM_DT,
    TABLE_Z,
    JointType,
    ObjType,
    SceneParams,
    SimState,
)

_DT = SIM_DT
_BIG_QV = 1e9


def _is_t(x):
    return isinstance(x, torch.Tensor)


class _x:
    """The jnp calls of the JAX module, on tensors or Python scalars.
    maximum/minimum/clip propagate NaN, as jnp's do."""

    pi = math.pi
    inf = math.inf

    @staticmethod
    def where(c, a, b):
        if isinstance(c, bool):
            return a if c else b
        return torch.where(c, a, b)

    @staticmethod
    def maximum(a, b):
        if _is_t(a) and _is_t(b):
            return torch.maximum(a, b)
        if _is_t(a):
            return torch.clamp(a, min=b)
        if _is_t(b):
            return torch.clamp(b, min=a)
        return max(a, b)

    @staticmethod
    def minimum(a, b):
        if _is_t(a) and _is_t(b):
            return torch.minimum(a, b)
        if _is_t(a):
            return torch.clamp(a, max=b)
        if _is_t(b):
            return torch.clamp(b, max=a)
        return min(a, b)

    @staticmethod
    def clip(x, lo, hi):
        return _x.minimum(_x.maximum(x, lo), hi)

    @staticmethod
    def abs(x):
        return torch.abs(x) if _is_t(x) else abs(x)

    @staticmethod
    def sqrt(x):
        return torch.sqrt(x) if _is_t(x) else math.sqrt(x)

    @staticmethod
    def sin(x):
        return torch.sin(x) if _is_t(x) else math.sin(x)

    @staticmethod
    def cos(x):
        return torch.cos(x) if _is_t(x) else math.cos(x)

    @staticmethod
    def exp(x):
        return torch.exp(x) if _is_t(x) else math.exp(x)

    @staticmethod
    def div(a, b):
        """a / b rounded once. PyTorch's CUDA kernels divide a tensor by a
        Python number as a multiply by its reciprocal (two roundings); a
        0-dim tensor on the same device keeps the true division, as the
        CPU, XLA and the CUDA kernel compute it."""
        if _is_t(a) and a.is_cuda and not _is_t(b):
            return a / a.new_full((), b)
        return a / b

    @staticmethod
    def sign(x):
        return torch.sign(x)

    @staticmethod
    def mod(a, b):
        return torch.remainder(a, b)

    @staticmethod
    def ones_like(x):
        return torch.ones_like(x)

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)

    @staticmethod
    def full_like(x, v):
        return torch.full_like(x, v)


def _f32(b):
    """bool lane -> 0/1 float lane (torch refuses `1.0 - bool`)."""
    return b.to(torch.float32)


# ---------------------------------------------------------------------------
# tuple-of-lanes vector/quaternion helpers (numerically identical to the
# array forms in physics/maths.py and engine._norm)
# ---------------------------------------------------------------------------

def _add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _norm3(a):
    return _x.sqrt(_x.maximum(_dot3(a, a), 1e-24))


def _norm2(x, y):
    return _x.sqrt(_x.maximum(x * x + y * y, 1e-24))


def _where3(c, a, b):
    return (_x.where(c, a[0], b[0]), _x.where(c, a[1], b[1]),
            _x.where(c, a[2], b[2]))


def _where4(c, a, b):
    return tuple(_x.where(c, x, y) for x, y in zip(a, b))


def _safe_normalize3(v, eps=1e-9):
    n = _x.sqrt(_x.maximum(_dot3(v, v), 1e-24))
    inv = 1.0 / _x.maximum(n, eps)
    return _scale3(v, inv)


def _qmul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return (
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    )


def _qrot(q, v):
    t = _qmul(q, (0.0, v[0], v[1], v[2]))
    out = _qmul(t, (q[0], -q[1], -q[2], -q[3]))
    return (out[1], out[2], out[3])


def _axquat(axis, angle):
    half = angle / 2.0
    s = _x.sin(half)
    return (_x.cos(half), axis[0] * s, axis[1] * s, axis[2] * s)


def _dot4(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3]


def _qnorm(q):
    inv = 1.0 / _x.sqrt(_x.maximum(_dot4(q, q), 1e-24))
    return (q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv)


def _qintegrate(q, omega, dt):
    dq = (0.0, omega[0] * dt, omega[1] * dt, omega[2] * dt)
    m = _qmul(dq, q)
    qn = tuple(q[k] + 0.5 * m[k] for k in range(4))
    return _qnorm(qn)


def _qnlerp(q, p, alpha):
    s = _x.sign(_dot4(q, p) + 1e-30)
    out = tuple(q[k] + alpha * (p[k] * s - q[k]) for k in range(4))
    return _qnorm(out)


def _atan2(y, x):
    """Polynomial atan2 built from Mosaic-supported primitives (the native
    atan2 HLO has no Pallas TPU lowering). Eigen's 8-coefficient odd minimax
    polynomial on [0, 1] (~1 ulp in f32) plus the usual octant fixup. Within
    ~2e-7 of atan2 everywhere the engine evaluates it."""
    ax, ay = _x.abs(x), _x.abs(y)
    mx = _x.maximum(ax, ay)
    mn = _x.minimum(ax, ay)
    z = mn / _x.maximum(mx, 1e-30)
    s = z * z
    p = 0.00282363896258175373077393
    p = p * s - 0.0159569028764963150024414
    p = p * s + 0.0425049886107444763183594
    p = p * s - 0.0748900920152664184570312
    p = p * s + 0.106347933411598205566406
    p = p * s - 0.142027363181114196777344
    p = p * s + 0.199926957488059997558594
    p = p * s - 0.333331018686294555664062
    a = z + z * s * p
    a = _x.where(ay > ax, (np.pi / 2) - a, a)
    a = _x.where(x < 0.0, np.pi - a, a)
    return _x.where(y < 0.0, -a, a)


def _argmin3(d0, d1, d2):
    """First-min-wins one-hot picks, matching argmin over 3 elements."""
    pick0 = (d0 <= d1) & (d0 <= d2)
    pick1 = (~pick0) & (d1 <= d2)
    pick2 = ~(pick0 | pick1)
    return pick0, pick1, pick2


def _sel3(pick0, pick1, v0, v1, v2):
    return _x.where(pick0, v0, _x.where(pick1, v1, v2))


# ---------------------------------------------------------------------------
# batched reach-envelope lookup (engine._reach_target_delta, engine.py:92-113;
# hoisted out of the substep — the mocap is constant across the 5 substeps,
# so the gather runs once per control step)
# ---------------------------------------------------------------------------

_RN = engine.REACH_N
_RGRID_FLAT = engine.REACH_DELTA.reshape(-1, 3)
_REACH_CACHE: dict = {}


def _reach_tables(device):
    """(lo, hi, n-1, flat grid) on `device`, copied there once."""
    key = str(device)
    if key not in _REACH_CACHE:
        _REACH_CACHE[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (engine.REACH_LO, engine.REACH_HI,
                      (_RN - 1).astype(np.float32), _RGRID_FLAT))
    return _REACH_CACHE[key]


def reach_target_delta(p):
    """Trilinear sample of the settled-tcp displacement field at mocap p
    ((..., 3) batched)."""
    lo, hi, nm1, grid = _reach_tables(p.device)
    t = (p - lo) / (hi - lo) * nm1
    t = torch.minimum(torch.clamp(t, min=0.0), nm1 - 1e-4)
    i0 = torch.floor(t).to(torch.int64)
    f = t - i0
    n1, n2 = int(_RN[1]), int(_RN[2])
    acc = torch.zeros_like(p)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[..., 0] if dx else 1.0 - f[..., 0])
                    * (f[..., 1] if dy else 1.0 - f[..., 1])
                    * (f[..., 2] if dz else 1.0 - f[..., 2])
                )
                idx = ((i0[..., 0] + dx) * n1 + (i0[..., 1] + dy)) * n2 + (
                    i0[..., 2] + dz)
                acc = acc + w[..., None] * grid[idx]
    ss = acc[..., 0] * acc[..., 0] + acc[..., 1] * acc[..., 1] \
        + acc[..., 2] * acc[..., 2]
    mag = torch.sqrt(torch.clamp(ss, min=1e-24))
    gate = torch.clamp((mag - 0.008) / 0.012, 0.0, 1.0)
    return acc * gate[..., None]


# ---------------------------------------------------------------------------
# pytree <-> lanes
# ---------------------------------------------------------------------------

def _v3(a):
    """(..., 3) array -> tuple of 3 lanes."""
    return (a[..., 0], a[..., 1], a[..., 2])


def _v4(a):
    return (a[..., 0], a[..., 1], a[..., 2], a[..., 3])


class _NS:
    """Plain attribute bag (not a pytree — scene lanes are closure
    constants; sim lanes travel through the scan as a dict)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def scene_lanes(scene: SceneParams) -> _NS:
    """Slice SceneParams into per-slot lane lists + hoisted derived lanes."""
    sc = _NS()
    g = scene
    sc.o_exists = [g.obj_exists[..., i] for i in range(MAX_OBJ)]
    sc.o_type = [g.obj_type[..., i] for i in range(MAX_OBJ)]
    sc.o_radius = [g.obj_radius[..., i] for i in range(MAX_OBJ)]
    sc.o_half_x = [g.obj_half_x[..., i] for i in range(MAX_OBJ)]
    sc.o_oo_half_x = [g.obj_oo_half_x[..., i] for i in range(MAX_OBJ)]
    sc.o_grasp_x_tol = [g.obj_grasp_x_tol[..., i] for i in range(MAX_OBJ)]
    sc.o_half_h = [g.obj_half_h[..., i] for i in range(MAX_OBJ)]
    sc.o_graspable = [g.obj_graspable[..., i] for i in range(MAX_OBJ)]
    sc.o_ghw = [g.obj_grasp_halfwidth[..., i] for i in range(MAX_OBJ)]
    sc.o_anchored = [g.obj_anchored[..., i] for i in range(MAX_OBJ)]
    sc.o_tool_off = [_v3(g.obj_tool_off[..., i, :]) for i in range(MAX_OBJ)]
    sc.o_droop = [g.obj_droop[..., i] for i in range(MAX_OBJ)]
    sc.o_grasp_off = [_v3(g.obj_grasp_off[..., i, :]) for i in range(MAX_OBJ)]
    sc.o_planar = [g.obj_planar[..., i] > 0 for i in range(MAX_OBJ)]
    sc.o_xy_limited = [g.obj_xy_limited[..., i] for i in range(MAX_OBJ)]
    sc.o_xy_lo = [(g.obj_xy_lo[..., i, 0], g.obj_xy_lo[..., i, 1])
                  for i in range(MAX_OBJ)]
    sc.o_xy_hi = [(g.obj_xy_hi[..., i, 0], g.obj_xy_hi[..., i, 1])
                  for i in range(MAX_OBJ)]
    sc.o_hookg = [g.obj_hook_grasp[..., i] for i in range(MAX_OBJ)]
    sc.link_enable = g.link_enable
    sc.link_handle_off = _v3(g.link_handle_off)

    sc.j_exists = [g.joint_exists[..., j] for j in range(MAX_JOINT)]
    sc.j_type = [g.joint_type[..., j] for j in range(MAX_JOINT)]
    sc.j_axis = [_v3(g.joint_axis[..., j, :]) for j in range(MAX_JOINT)]
    sc.j_anchor = [_v3(g.joint_anchor[..., j, :]) for j in range(MAX_JOINT)]
    sc.j_arm = [_v3(g.joint_arm[..., j, :]) for j in range(MAX_JOINT)]
    sc.j_range = [(g.joint_range[..., j, 0], g.joint_range[..., j, 1])
                  for j in range(MAX_JOINT)]
    sc.j_damping = [g.joint_damping[..., j] for j in range(MAX_JOINT)]
    sc.j_stiffness = [g.joint_stiffness[..., j] for j in range(MAX_JOINT)]
    sc.j_springref = [g.joint_springref[..., j] for j in range(MAX_JOINT)]
    sc.j_inertia = [g.joint_inertia[..., j] for j in range(MAX_JOINT)]
    sc.j_bias = [g.joint_bias[..., j] for j in range(MAX_JOINT)]
    sc.j_mass = [g.joint_mass[..., j] for j in range(MAX_JOINT)]
    sc.j_com = [_v3(g.joint_com[..., j, :]) for j in range(MAX_JOINT)]
    sc.j_handle_radius = [g.joint_handle_radius[..., j] for j in range(MAX_JOINT)]
    sc.j_face_radius = [g.joint_face_radius[..., j] for j in range(MAX_JOINT)]
    sc.j_press_off = [_v3(g.joint_press_off[..., j, :]) for j in range(MAX_JOINT)]
    sc.j_face_dir = [_v3(g.joint_face_dir[..., j, :]) for j in range(MAX_JOINT)]
    sc.j_hook_carry = [g.joint_hook_carry[..., j] for j in range(MAX_JOINT)]
    sc.j_hookable = [g.joint_hookable[..., j] for j in range(MAX_JOINT)]
    sc.j_panel_off = [g.joint_panel_off[..., j] for j in range(MAX_JOINT)]
    sc.j_panel = [g.joint_panel[..., j] for j in range(MAX_JOINT)]

    sc.s_exists = [g.static_exists[..., s] for s in range(MAX_STATIC)]
    sc.s_pos = [_v3(g.static_pos[..., s, :]) for s in range(MAX_STATIC)]
    sc.s_size = [_v3(g.static_size[..., s, :]) for s in range(MAX_STATIC)]
    sc.s_rel = [g.static_rel[..., s] for s in range(MAX_STATIC)]

    sc.hole_c = (g.hole_center[..., 0], g.hole_center[..., 1])
    sc.hole_h = (g.hole_halfsize[..., 0], g.hole_halfsize[..., 1])
    sc.pit_depth = g.pit_depth
    sc.table_z = g.table_z

    # --- hoisted derived lanes (constant across the control step) ---
    sc.is_sphere = [t == ObjType.SPHERE for t in sc.o_type]
    sc.is_hinge = [t == JointType.HINGE for t in sc.j_type]
    sc.blk = [g.static_exists[..., s] * g.static_blocks_hand[..., s]
              for s in range(MAX_STATIC)]
    sc.has_bar = [_norm3(sc.j_face_dir[j]) > 0.5 for j in range(MAX_JOINT)]
    # hinge lever radius (engine.py:897-902)
    sc.lever = []
    for j in range(MAX_JOINT):
        arm, axis = sc.j_arm[j], sc.j_axis[j]
        arm_perp = _sub3(arm, _scale3(axis, _dot3(arm, axis)))
        lv = _x.where(sc.is_hinge[j], _norm3(arm_perp), 1.0)
        sc.lever.append(_x.maximum(lv, 1e-6))
    # planar viscous decay per substep (engine.py:497-499)
    sc.visc = [
        _x.exp(-g.obj_lin_damping[..., i] * _DT
                / _x.maximum(g.obj_mass[..., i], 1e-6))
        for i in range(MAX_OBJ)
    ]
    # pad drag blend by type (engine.py:515)
    sc.blend = [_x.where(sc.is_sphere[i], 0.04, 0.35) for i in range(MAX_OBJ)]
    # ground Coulomb coefficient (engine.py:647)
    sc.fric = [g.obj_friction[..., i] * (1.0 - g.obj_planar[..., i])
               for i in range(MAX_OBJ)]
    # sphere-only downward settle gate (engine.py:470-471)
    sc.sphere_dn = [
        _f32(sc.o_type[i] == ObjType.SPHERE)
        for i in range(MAX_OBJ)
    ]
    # exact exponential joint integrator factors (engine.py:884-892)
    sc.j_decay = [
        _x.exp(-sc.j_damping[j] * _DT / _x.maximum(sc.j_inertia[j], 1e-6))
        for j in range(MAX_JOINT)
    ]
    sc.j_off_cap = [
        _x.where(sc.is_hinge[j], 0.15, 0.02) for j in range(MAX_JOINT)
    ]
    return sc


def sim_lanes(sim: SimState) -> dict:
    """SimState -> dict-of-lanes pytree (carried through the substep scan)."""
    return {
        "hand": _v3(sim.hand),
        "hand_vel": _v3(sim.hand_vel),
        "gripper": sim.gripper,
        "gripper_vel": sim.gripper_vel,
        "obj_pos": [_v3(sim.obj_pos[..., i, :]) for i in range(MAX_OBJ)],
        "obj_quat": [_v4(sim.obj_quat[..., i, :]) for i in range(MAX_OBJ)],
        "obj_vel": [_v3(sim.obj_vel[..., i, :]) for i in range(MAX_OBJ)],
        "obj_angvel": [_v3(sim.obj_angvel[..., i, :]) for i in range(MAX_OBJ)],
        "joint_q": [sim.joint_q[..., j] for j in range(MAX_JOINT)],
        "joint_v": [sim.joint_v[..., j] for j in range(MAX_JOINT)],
        "attached": [sim.attached[..., i] for i in range(MAX_OBJ)],
        "attach_off": [_v3(sim.attach_off[..., i, :]) for i in range(MAX_OBJ)],
        "unanchored": [sim.unanchored[..., i] for i in range(MAX_OBJ)],
        "hooked": [sim.hooked[..., j] for j in range(MAX_JOINT)],
        "hook_off": [sim.hook_off[..., j] for j in range(MAX_JOINT)],
        "hook_hoff": [_v3(sim.hook_hoff[..., j, :]) for j in range(MAX_JOINT)],
        "pad_force_l": sim.pad_force_l,
        "pad_force_r": sim.pad_force_r,
        "fixture_pos": _v3(sim.fixture_pos),
    }


def _stack_last(lanes):
    return torch.stack(lanes, dim=-1)


def lanes_to_sim(st: dict, mocap, gripper_pads) -> SimState:
    pad_l, pad_r = gripper_pads
    return SimState(
        mocap=mocap,
        hand=_stack_last(st["hand"]),
        hand_vel=_stack_last(st["hand_vel"]),
        gripper=st["gripper"],
        gripper_vel=st["gripper_vel"],
        obj_pos=torch.stack([_stack_last(v) for v in st["obj_pos"]], dim=-2),
        obj_quat=torch.stack([_stack_last(v) for v in st["obj_quat"]], dim=-2),
        obj_vel=torch.stack([_stack_last(v) for v in st["obj_vel"]], dim=-2),
        obj_angvel=torch.stack([_stack_last(v) for v in st["obj_angvel"]], dim=-2),
        joint_q=_stack_last(st["joint_q"]),
        joint_v=_stack_last(st["joint_v"]),
        attached=_stack_last(st["attached"]),
        attach_off=torch.stack([_stack_last(v) for v in st["attach_off"]], dim=-2),
        unanchored=_stack_last(st["unanchored"]),
        hooked=_stack_last(st["hooked"]),
        hook_off=_stack_last(st["hook_off"]),
        hook_hoff=torch.stack([_stack_last(v) for v in st["hook_hoff"]], dim=-2),
        pad_force_l=st["pad_force_l"],
        pad_force_r=st["pad_force_r"],
        pad_l=pad_l,
        pad_r=pad_r,
        fixture_pos=_stack_last(st["fixture_pos"]),
    )


# ---------------------------------------------------------------------------
# geometry helpers in lane form
# ---------------------------------------------------------------------------

def _support_z(sc, x, y):
    """engine._support_z (engine.py:192-200)."""
    base = TABLE_Z + sc.table_z
    in_hole = (_x.abs(x - sc.hole_c[0]) < sc.hole_h[0]) & (
        _x.abs(y - sc.hole_c[1]) < sc.hole_h[1])
    has_hole = (sc.hole_h[0] > 0.0) | (sc.hole_h[1] > 0.0)
    return _x.where(has_hole & in_hole, base - sc.pit_depth, base)


def _static_box_world(sc, s, fixture):
    """engine._static_boxes_world for one box (engine.py:203-205)."""
    rel = sc.s_rel[s]
    return _add3(sc.s_pos[s], _scale3(fixture, rel)), sc.s_size[s]


def _sphere_box_pushout(p, r, bp, bs):
    """engine._sphere_box_pushout (engine.py:208-228). Returns (corr, n, pen)."""
    d = _sub3(p, bp)
    clamped = tuple(_x.clip(d[k], -bs[k], bs[k]) for k in range(3))
    delta = tuple(d[k] - clamped[k] for k in range(3))
    dist = _norm3(delta)
    inv = 1.0 / _x.maximum(dist, 1e-9)
    n_out = _scale3(delta, inv)
    pen_out = _x.maximum(r - dist, 0.0)
    inside = dist < 1e-9
    depth = tuple(bs[k] - _x.abs(d[k]) + r for k in range(3))
    pick0, pick1, _ = _argmin3(*depth)
    d_axis = _sel3(pick0, pick1, d[0], d[1], d[2])
    sgn = _x.sign(d_axis) + (d_axis == 0.0)
    n_in = (_x.where(pick0, sgn, 0.0), _x.where(pick1, sgn, 0.0),
            _x.where(pick0 | pick1, 0.0, sgn))
    pen_in = _sel3(pick0, pick1, depth[0], depth[1], depth[2])
    n = _where3(inside, n_in, n_out)
    pen = _x.where(inside, pen_in, pen_out)
    return _scale3(n, pen), n, pen


def _pad_centers(hand, gripper):
    """engine.pad_kinematics (engine.py:160-172)."""
    gap = gripper * GRIPPER_FULL_OPEN - PAD_GAP_INSET
    half = gap / 2.0
    up = hand[2] + PAD_Z_OFFSET
    left = (hand[0], hand[1] + half, up)
    right = (hand[0], hand[1] - half, up)
    return left, right


def _handle_pos(sc, j, fixture, q):
    """engine.fixture_handle_pos for one joint (engine.py:1473-1482)."""
    anchor = _add3(fixture, sc.j_anchor[j])
    slide = _add3(anchor, _scale3(sc.j_axis[j], q))
    quat = _axquat(sc.j_axis[j], q)
    arm = _qrot(quat, sc.j_arm[j])
    hinge = _add3(anchor, arm)
    return _where3(sc.is_hinge[j], hinge, slide)


def _motion_dir(sc, j, q):
    """engine.fixture_motion_dir for one joint (engine.py:1485-1492)."""
    quat = _axquat(sc.j_axis[j], q)
    arm = _qrot(quat, sc.j_arm[j])
    tangent = _safe_normalize3(_cross3(sc.j_axis[j], arm))
    axis_n = _safe_normalize3(sc.j_axis[j])
    return _where3(sc.is_hinge[j], tangent, axis_n)


def _fixture_inverse(sc, j, fixture, point):
    """engine.fixture_inverse for one joint (engine.py:1495-1511)."""
    anchor = _add3(fixture, sc.j_anchor[j])
    rel = _sub3(point, anchor)
    axis = sc.j_axis[j]
    q_slide = _dot3(rel, axis)
    rel_p = _sub3(rel, _scale3(axis, _dot3(rel, axis)))
    arm0 = sc.j_arm[j]
    arm_p = _sub3(arm0, _scale3(axis, _dot3(arm0, axis)))
    cosq = _dot3(rel_p, arm_p)
    sinq = _dot3(_cross3(arm_p, rel_p), axis)
    q_hinge = _atan2(
        sinq, _x.where((_x.abs(sinq) + _x.abs(cosq)) < 1e-12, 1.0, cosq))
    return _x.where(sc.is_hinge[j], q_hinge, q_slide)


# constant claw-part geometry (engine.py:1108, 1194, 1204-1205)
_KNUCKLE_HALF = (0.022, 0.040, 0.053)
_PLATE_HALF = (0.015, 0.0045, 0.045)
_RAIL_HALF = (0.005, 0.055, 0.005)
_PAD_HALF_BLK = (0.015, 0.0045, 0.045)
_PAD_HALF = (0.015, 0.0045, 0.045)
_SETTLE = float(1.0 - np.exp(-_DT / 0.05))
_SETTLE_DN = float(1.0 - np.exp(-_DT / 0.20))
_OMEGA_DECAY = float(np.exp(-_DT / 0.04))
_ALPHA_R = float(1.0 - np.exp(-_DT / 0.08))
_ALPHA_D = float(1.0 - np.exp(-_DT / 0.35))
_WEDGE_A = float(1.0 - np.exp(-_DT / 0.15))
_TCP_OFFSET_F = tuple(float(np.float32(x)) for x in engine.TCP_OFFSET)
_D_SLIDE_DECAY = float(1.0 - np.exp(-_D_SLIDE_LIM * _DT))
_PAD_K = 4000.0


# ---------------------------------------------------------------------------
# the substep (translates engine.control_step's substep, engine.py:310-1463)
# ---------------------------------------------------------------------------

def _substep(sc, st, target, effort, *, with_objects=True, with_joints=True,
             with_hand_boxes=True):
    """One physics substep. The with_* kwargs are PYTHON-STATIC feature
    flags: a False drops that section from the traced program entirely and
    substitutes identity outputs. Correct only when the corresponding scene
    features are absent for every lane (obj_exists / joint_exists /
    static_blocks_hand all zero) — the generic all-True form is always
    sound. The Pallas kernel switches between specialized variants per env
    block (blocks are task-contiguous, and most tasks exercise only one
    feature family), cutting the per-block instruction count ~2x."""
    dt = _DT
    hand0 = st["hand"]

    # --- hand tracking (second-order weld, engine.py:312-332) ---
    vel_h = st["hand_vel"]
    acc = tuple(
        HAND_W * HAND_W * (target[k] - hand0[k])
        - 2.0 * HAND_ZETA * HAND_W * vel_h[k]
        for k in range(3)
    )
    vel_h = tuple(vel_h[k] + acc[k] * dt for k in range(3))
    vn = _norm3(vel_h)
    vel_h = _scale3(vel_h, _x.minimum(1.0, HAND_VMAX / _x.maximum(vn, 1e-9)))
    new_hand = tuple(hand0[k] + vel_h[k] * dt for k in range(3))

    # --- hand vs static geometry (engine.py:334-392 hand_clear) ---
    fixture = st["fixture_pos"]
    boxes = [_static_box_world(sc, s, fixture) for s in range(MAX_STATIC)]

    def _sum3(vs):
        acc = vs[0]
        for v in vs[1:]:
            acc = _add3(acc, v)
        return acc

    if with_hand_boxes:
        h = new_hand
        tip = _sum3([
            _scale3(_sphere_box_pushout(h, _HAND_TIP_R, bp, bs)[0], sc.blk[s])
            for s, (bp, bs) in enumerate(boxes)
        ])
        h = _add3(h, tip)
        h_up = (h[0], h[1], h[2] + 0.105)
        knuckle_c = _sum3([
            _scale3(_sphere_box_pushout(h_up, _HAND_KNUCKLE_R, bp, bs)[0],
                    sc.blk[s])
            for s, (bp, bs) in enumerate(boxes)
        ])
        h = _add3(h, knuckle_c)

        def _pad_box_corr(pc, bp, bs, on):
            """engine.py:366-386 one_p: pad plate AABB vs scene box."""
            d = _sub3(pc, bp)
            pen = tuple(_PAD_HALF_BLK[k] + bs[k] - _x.abs(d[k])
                        for k in range(3))
            hit = (pen[0] > 0.0) & (pen[1] > 0.0) & (pen[2] > 0.0) & (on > 0)
            pick0, pick1, _ = _argmin3(*pen)
            pen_h = _x.minimum(pen[0], pen[1])
            use_h = pen_h < _PAD_TIP_BEVEL
            h0 = pen[0] <= pen[1]
            # logical blend, not _x.where-on-bools (Mosaic cannot lower an
            # i8->i1 select; i1 logic ops lower cleanly)
            p0 = (use_h & h0) | (~use_h & pick0)
            p1 = (use_h & ~h0) | (~use_h & pick1)
            d_axis = _sel3(p0, p1, d[0], d[1], d[2])
            sgn = _x.where(d_axis >= 0, 1.0, -1.0)
            mag = _x.where(hit, _sel3(p0, p1, pen[0], pen[1], pen[2]), 0.0)
            return (_x.where(p0, mag * sgn, 0.0),
                    _x.where(p1, mag * sgn, 0.0),
                    _x.where(p0 | p1, 0.0, mag * sgn))

        for pc in _pad_centers(h, st["gripper"]):
            corr_p = _sum3([
                _pad_box_corr(pc, bp, bs, sc.blk[s])
                for s, (bp, bs) in enumerate(boxes)
            ])
            h = _add3(h, corr_p)
        raw_hand = new_hand
        new_hand = h

        # Coulomb stick/slip pin against blocked boxes (engine.py:396-419)
        corr_h = _sub3(new_hand, raw_hand)
        cn_h = _norm3(corr_h)
        n_h_dir = _scale3(corr_h, 1.0 / _x.maximum(cn_h, 1e-9))
        dv_h = _sub3(new_hand, hand0)
        dvn = _dot3(dv_h, n_h_dir)
        dv_n_h = _scale3(n_h_dir, dvn)
        dv_t_h = _sub3(dv_h, dv_n_h)
        t_mag = _norm3(dv_t_h)
        t_allow = _x.maximum(t_mag - _MU_HAND * cn_h, 0.0)
        scale_t = _x.where(cn_h > 1e-9, t_allow / _x.maximum(t_mag, 1e-9),
                            1.0)
        new_hand = tuple(hand0[k] + dv_n_h[k] + dv_t_h[k] * scale_t
                         for k in range(3))
    hand_vel = tuple(_x.div(new_hand[k] - hand0[k], dt) for k in range(3))

    # --- grasped-object gap clamp (engine.py:422-432 + _grasp_geometry) ---
    gap0 = st["gripper"] * GRIPPER_FULL_OPEN
    caged, can_grasp, squeezed_out = [], [], []
    if with_objects:
        for i in range(MAX_OBJ):
            gp = _add3(st["obj_pos"][i], sc.o_grasp_off[i])
            rel = _sub3(gp, hand0)
            between = _x.abs(rel[1]) < gap0 / 2.0 + 0.01
            near_x = _x.abs(rel[0]) < _GRASP_XZ_TOL
            near_z = (rel[2] > -0.025) & (rel[2] < _GRASP_Z_SPAN)
            c = between & near_x & near_z
            caged.append(c)
            cg = c & (sc.o_graspable[i] > 0) & (sc.o_exists[i] > 0)
            # over-squeeze squirt gate (engine.py squeezed_out)
            sq = (cg & (st["attached"][i] == 0)
                  & (gap0 < sc.o_ghw[i]) & (sc.o_hookg[i] == 0))
            squeezed_out.append(sq)
            can_grasp.append(cg & ~sq)
        obj_gap = [
            _x.where(can_grasp[i] | (st["attached"][i] > 0),
                      2.0 * sc.o_ghw[i] + PAD_GAP_INSET, 0.0)
            for i in range(MAX_OBJ)
        ]
        clamp_gap = obj_gap[0]
        for i in range(1, MAX_OBJ):
            clamp_gap = _x.maximum(clamp_gap, obj_gap[i])
    else:
        clamp_gap = 0.0

    # --- gripper ODE (engine.py:248-283) ---
    closed = _x.div(GRIPPER_FULL_OPEN - gap0, GRIPPER_FULL_OPEN)
    q_r = closed * 0.1 * (0.04 / 0.07)
    q_l = -closed * 0.1 * (0.03 / 0.07)
    v = st["gripper_vel"] * GRIPPER_FULL_OPEN
    v_r = -v * (0.04 / 0.07)
    v_l = v * (0.03 / 0.07)
    e = _x.clip(effort, -1.0, 1.0)
    acc_r = _x.div(_F_KP * (e - q_r) - _F_DAMP * v_r, _F_MASS)
    acc_l = _x.div(_F_KP * (-e - q_l) - _F_DAMP * v_l, _F_MASS)
    v_r = v_r + acc_r * dt
    v_l = v_l + acc_l * dt
    q_r_new = _x.clip(q_r + v_r * dt, *_R_RANGE)
    q_l_new = _x.clip(q_l + v_l * dt, *_L_RANGE)
    new_gap = GRIPPER_FULL_OPEN - (q_r_new - q_l_new)
    clamped_gap = _x.maximum(new_gap, clamp_gap)
    binds = clamp_gap > new_gap
    # squeeze-through creep for an unattached cage (engine.py clamp)
    if with_objects:
        hard_clamp = st["attached"][0] > 0
        for i in range(1, MAX_OBJ):
            hard_clamp = hard_clamp | (st["attached"][i] > 0)
        soft_gap = _x.maximum(
            _x.minimum(clamped_gap, gap0 - _SQUEEZE_CREEP * dt),
            GRIPPER_FULL_OPEN - (_R_RANGE[1] - _L_RANGE[0]),
        )
        clamped_gap = _x.where(hard_clamp | ~binds, clamped_gap, soft_gap)
    squeeze = _x.where(binds, _x.maximum(_F_KP * (e - q_r_new), 0.0), 0.0)
    gripper_vel = _x.where(binds, 0.0, _x.div(_x.div(clamped_gap - gap0, dt), GRIPPER_FULL_OPEN))
    gripper = _x.div(clamped_gap, GRIPPER_FULL_OPEN)

    if with_objects:
        # --- attach / detach (engine.py:434-482) ---
        gap_m = gripper * GRIPPER_FULL_OPEN
        attached, attach_off, unanchored = [], [], []
        for i in range(MAX_OBJ):
            gripping = (effort > 0.0) & ((squeeze > 0.0) | (sc.o_hookg[i] > 0))
            # weld gated on x-centering (engine.py tight_x)
            tight_x = (
                _x.abs(st["obj_pos"][i][0] + sc.o_grasp_off[i][0]
                        - hand0[0]) < sc.o_grasp_x_tol[i]
            )
            newly = can_grasp[i] & tight_x & gripping & (st["attached"][i] == 0)
            ao = _where3(newly, _sub3(st["obj_pos"][i], new_hand), st["attach_off"][i])
            att = _x.where(newly, 1.0, st["attached"][i])
            una = _x.where(newly, 1.0, st["unanchored"][i])
            release = (effort <= 0.0) | (
                (gap_m > 2.0 * sc.o_ghw[i] + PAD_GAP_INSET + 0.01)
                & (sc.o_hookg[i] == 0)
            )
            att = _x.where(release, 0.0, att)
            att = att * sc.o_exists[i] * sc.o_graspable[i]
            # in-grip settle (engine.py:458-482); upward settle gated on
            # the object being OFF its support (engine.py settle_up)
            settle_dn = _SETTLE_DN * sc.sphere_dn[i]
            tx = -sc.o_grasp_off[i][0]
            ty = -sc.o_grasp_off[i][1]
            off_x = tx + (ao[0] - tx) * (1.0 - _SETTLE)
            off_y = ty + (ao[1] - ty) * (1.0 - _SETTLE)
            canon_z = 0.006 - sc.o_grasp_off[i][2]
            sup_settle = _support_z(sc, st["obj_pos"][i][0],
                                    st["obj_pos"][i][1])
            resting_now = (st["obj_pos"][i][2]
                           <= sup_settle + sc.o_half_h[i] + 1e-4)
            settle_up = _SETTLE * (1.0 - _f32(resting_now))
            off_z = _x.where(
                ao[2] < canon_z,
                ao[2] + (canon_z - ao[2]) * settle_up,
                ao[2] + (canon_z - ao[2]) * settle_dn,
            )
            ao = _where3(att > 0, (off_x, off_y, off_z), ao)
            attached.append(att)
            attach_off.append(ao)
            unanchored.append(una)

        # --- free-object dynamics (engine.py:484-502) ---
        pos, vel, pinned_anchor, free_old = [], [], [], []
        for i in range(MAX_OBJ):
            pa = (sc.o_anchored[i] > 0) & (unanchored[i] == 0)
            pinned_anchor.append(pa)
            planar = sc.o_planar[i]
            v3 = st["obj_vel"][i]
            vz = v3[2] - _GRAVITY * dt * (~planar)
            vz = vz * (1.0 - _f32(planar))
            v3 = (v3[0], v3[1], vz)
            v3 = _where3(planar, _scale3(v3, sc.visc[i]), v3)
            v3 = _where3(pa, (0.0 * v3[0], 0.0 * v3[1], 0.0 * v3[2]), v3)
            # over-squeeze squirt along the pad axis (engine.py squirt)
            ej_sign = _x.sign(st["obj_pos"][i][0] + sc.o_grasp_off[i][0]
                               - hand0[0])
            ej_sign = _x.where(ej_sign == 0.0, -1.0, ej_sign)
            vx_sq = _x.where(
                squeezed_out[i],
                ej_sign * _x.maximum(_x.abs(v3[0]), 0.2), v3[0])
            v3 = (vx_sq, v3[1], v3[2])
            # pin nonexistent (padding) slots (see engine.py)
            ex = sc.o_exists[i] > 0
            v3 = tuple(v3[k] * ex for k in range(3))
            p3 = _where3(ex, _add3(st["obj_pos"][i], _scale3(v3, dt)),
                         st["obj_pos"][i])
            pos.append(p3)
            vel.append(v3)
            free_old.append((st["attached"][i] == 0) & (sc.o_exists[i] > 0) & ~pa)

        # --- finger-pad pushing (engine.py:504-582) ---
        left, right = _pad_centers(hand0, st["gripper"])
        pad_push_depth = []   # [pad][obj]
        pad_side_hit = []     # [pad][obj]
        for kin_c in (left, right):
            depths, sides = [], []
            for i in range(MAX_OBJ):
                p, v3 = pos[i], vel[i]
                radius, half_x, half_h = sc.o_radius[i], sc.o_half_x[i], sc.o_half_h[i]
                obj_half = (half_x, radius, half_h)
                d = _sub3(p, kin_c)
                pen_box = tuple(_PAD_HALF[k] + obj_half[k] - _x.abs(d[k])
                                for k in range(3))
                hit_box = (pen_box[0] > 0.0) & (pen_box[1] > 0.0) & (pen_box[2] > 0.0)
                pick0, pick1, _ = _argmin3(*pen_box)
                d_axis = _sel3(pick0, pick1, d[0], d[1], d[2])
                sgn = _x.where(d_axis >= 0, 1.0, -1.0)
                n_box = (_x.where(pick0, sgn, 0.0), _x.where(pick1, sgn, 0.0),
                         _x.where(pick0 | pick1, 0.0, sgn))
                depth_box = _x.where(
                    hit_box, _sel3(pick0, pick1, pen_box[0], pen_box[1], pen_box[2]),
                    0.0)
                _, n_sph, pen_sph = _sphere_box_pushout(p, radius, kin_c, _PAD_HALF)
                is_sph = sc.is_sphere[i]
                n = _where3(is_sph, n_sph, n_box)
                depth = _x.where(is_sph, pen_sph, depth_box)
                hit = depth > 0.0
                frac = _x.where(is_sph, 0.3, 1.0)
                p = _add3(p, _scale3(n, frac * depth))
                v_rel_n = _dot3(_sub3(v3, hand_vel), n)
                v3 = _where3(hit & (v_rel_n < 0.0), _sub3(v3, _scale3(n, v_rel_n)), v3)
                hand_n = _dot3(hand_vel, n)
                ball_n = _dot3(v3, n)
                boost = _x.where(
                    hit & is_sph & (hand_n > 0.0) & (ball_n < 1.3 * hand_n),
                    1.3 * hand_n - ball_n, 0.0)
                v3 = _add3(v3, _scale3(n, boost))
                dv = _sub3(hand_vel, v3)
                dv_t = _sub3(dv, _scale3(n, _dot3(dv, n)))
                blend_eff = _x.where((~is_sph) & (_x.abs(n[2]) > 0.7), 0.8,
                                      sc.blend[i])
                v3 = _add3(v3, _scale3(dv_t, _x.where(hit, blend_eff, 0.0)))
                side_hit = hit & (_x.abs(n[2]) < 0.7)
                pos[i] = _where3(free_old[i], p, pos[i])
                vel[i] = _where3(free_old[i], v3, vel[i])
                depths.append(depth * sc.o_exists[i])
                sides.append(side_hit & (sc.o_exists[i] > 0))
            pad_push_depth.append(depths)
            pad_side_hit.append(sides)

        # --- object-object contact (engine.py obj-obj AABB block): axis-
        # separated AABB with the OO x-reach (o_oo_half_x), mobility split
        # with beyond-slide-range bodies as anchors, held-pusher drag ---
        delta01 = _sub3(pos[0], pos[1])
        hs_oo = (sc.o_oo_half_x[0] + sc.o_oo_half_x[1],
                 sc.o_radius[0] + sc.o_radius[1],
                 sc.o_half_h[0] + sc.o_half_h[1])
        pen_ax = tuple(hs_oo[k] - _x.abs(delta01[k]) for k in range(3))
        hit_oo = (pen_ax[0] > 0.0) & (pen_ax[1] > 0.0) & (pen_ax[2] > 0.0)
        pick0, pick1, _ = _argmin3(*pen_ax)
        d_ax = _sel3(pick0, pick1, delta01[0], delta01[1], delta01[2])
        sgn_oo = _x.where(d_ax >= 0.0, 1.0, -1.0)
        mag_oo = _x.where(hit_oo,
                           _sel3(pick0, pick1, pen_ax[0], pen_ax[1], pen_ax[2]),
                           0.0)
        n01 = (_x.where(pick0, sgn_oo, 0.0),
               _x.where(pick1, sgn_oo, 0.0),
               _x.where(pick0 | pick1, 0.0, sgn_oo))
        pen01 = mag_oo
        both = ((sc.o_exists[0] > 0) & (sc.o_exists[1] > 0)
                & (sc.link_enable == 0))
        beyond_range = []
        for i in range(MAX_OBJ):
            v_abs = 0.0
            for k in range(2):
                viol_k = (_x.minimum(pos[i][k] - sc.o_xy_lo[i][k], 0.0)
                          + _x.maximum(pos[i][k] - sc.o_xy_hi[i][k], 0.0))
                v_abs = v_abs + _x.abs(viol_k)
            beyond_range.append((sc.o_xy_limited[i] > 0) & (v_abs > 1e-9))
        mobile = [(st["attached"][i] == 0) & ~pinned_anchor[i]
                  & (sc.o_exists[i] > 0) & ~beyond_range[i]
                  for i in range(MAX_OBJ)]
        w_tot = _x.maximum(mobile[0] + mobile[1] * 1.0, 1.0)
        w = [mobile[i] / w_tot for i in range(2)]
        active01 = both & (pen01 > 0.0)
        pen_act = _x.where(active01, pen01, 0.0)
        pos[0] = _add3(pos[0], _scale3(n01, pen_act * w[0]))
        pos[1] = _sub3(pos[1], _scale3(n01, pen_act * w[1]))
        v_n01 = _dot3(_sub3(vel[0], vel[1]), n01)
        approaching = v_n01 < 0.0
        vn_act = _x.where(active01 & approaching, v_n01, 0.0)
        vel[0] = _sub3(vel[0], _scale3(n01, vn_act * w[0]))
        vel[1] = _add3(vel[1], _scale3(n01, vn_act * w[1]))
        # held-pusher tangential drag (engine.py obj-obj drag)
        drag_on = active01 & ((st["attached"][0] > 0) | (st["attached"][1] > 0))
        for i in range(MAX_OBJ):
            dv_oo = _sub3(hand_vel, vel[i])
            dv_oo_t = _sub3(dv_oo, _scale3(n01, _dot3(dv_oo, n01)))
            take = (mobile[i] & (st["attached"][i] == 0)) * _x.where(
                drag_on, 0.8, 0.0)
            vel[i] = _add3(vel[i], _scale3(dv_oo_t, take))

        # --- static boxes (engine.py:612-628) ---
        def _box_contacts(p, r):
            return _sum3([
                _scale3(_sphere_box_pushout(p, r, bp, bs)[0], sc.s_exists[s])
                for s, (bp, bs) in enumerate(boxes)
            ])

        for i in range(MAX_OBJ):
            corr = _box_contacts(pos[i], sc.o_radius[i])
            pos[i] = _add3(pos[i], _scale3(corr, free_old[i]))
            corr_n = _safe_normalize3(corr)
            v_into = _x.minimum(_dot3(vel[i], corr_n), 0.0)
            hit_box = (_norm3(corr) > 1e-9) & free_old[i]
            vel[i] = _where3(hit_box, _sub3(vel[i], _scale3(corr_n, v_into)), vel[i])

        # --- ground / pit support (engine.py:630-662): friction impulse scales
        # with the normal impulse — a landing absorbs the downward speed, so a
        # block dropped while sliding stops nearly dead (spheres roll, exempt) ---
        for i in range(MAX_OBJ):
            p, v3 = pos[i], vel[i]
            sz = _support_z(sc, p[0], p[1])
            below = p[2] - sc.o_half_h[i] < sz
            p = (p[0], p[1], p[2] + _x.where(below, sz + sc.o_half_h[i] - p[2], 0.0))
            vz_new = _x.where(below & (v3[2] < 0.0), 0.0, v3[2])
            no_imp = sc.is_sphere[i] | (sc.o_xy_limited[i] > 0)
            absorbed = _x.where(below & (v3[2] < 0.0) & ~no_imp,
                                 -v3[2], 0.0)
            speed = _norm2(v3[0], v3[1])
            dec = sc.fric[i] * (_GRAVITY * dt + absorbed)
            scl = _x.where(speed > 1e-9,
                            _x.maximum(speed - dec, 0.0) / _x.maximum(speed, 1e-9),
                            0.0)
            xy_scale = _x.where(below, scl, 1.0)
            v3 = (v3[0] * xy_scale, v3[1] * xy_scale, vz_new)
            pos[i] = _where3(free_old[i], p, pos[i])
            vel[i] = _where3(free_old[i], v3, vel[i])

        # --- planar pinning (engine.py:652-658) ---
        for i in range(MAX_OBJ):
            sz_pl = _support_z(sc, pos[i][0], pos[i][1])
            z_pin = sz_pl + sc.o_half_h[i]
            pin = sc.o_planar[i] & free_old[i]
            pos[i] = (pos[i][0], pos[i][1], _x.where(pin, z_pin, pos[i][2]))
            vel[i] = (vel[i][0], vel[i][1], _x.where(pin, 0.0, vel[i][2]))

        # --- limited slide joints (engine.py:660-682) ---
        for i in range(MAX_OBJ):
            lim_on = sc.o_xy_limited[i] * free_old[i]
            side_held = pad_side_hit[0][i] | pad_side_hit[1][i]
            vx, vy, vz = vel[i]
            for k in range(2):
                viol = (_x.minimum(pos[i][k] - sc.o_xy_lo[i][k], 0.0)
                        + _x.maximum(pos[i][k] - sc.o_xy_hi[i][k], 0.0))
                outside = lim_on * (_x.abs(viol) > 0.0)
                comp = (vx, vy)[k]
                comp = comp - _K_SLIDE_LIM * viol * dt * lim_on * (1.0 - _f32(side_held))
                comp = comp * (1.0 - outside * _D_SLIDE_DECAY)
                if k == 0:
                    vx = comp
                else:
                    vy = comp
            vel[i] = (vx, vy, vz)

        # --- jam back-reaction (engine.py:684-721) ---
        jam_corr = (0.0, 0.0, 0.0)
        for kin_c in (left, right):
            for i in range(MAX_OBJ):
                obj_half = (sc.o_half_x[i], sc.o_radius[i], sc.o_half_h[i])
                d = _sub3(kin_c, pos[i])
                pen = tuple(_PAD_HALF[k] + obj_half[k] - _x.abs(d[k])
                            for k in range(3))
                hit = (
                    (pen[0] > 0.0) & (pen[1] > 0.0) & (pen[2] > 0.0)
                    & (sc.o_exists[i] > 0) & (sc.o_graspable[i] == 0)
                    & (st["attached"][i] == 0) & (sc.o_type[i] != ObjType.SPHERE)
                )
                pick0, pick1, _ = _argmin3(*pen)
                d_axis = _sel3(pick0, pick1, d[0], d[1], d[2])
                sgn = _x.where(d_axis >= 0, 1.0, -1.0)
                mag = _x.where(hit, _sel3(pick0, pick1, pen[0], pen[1], pen[2]), 0.0)
                jam_corr = _add3(jam_corr, (
                    _x.where(pick0, mag * sgn, 0.0),
                    _x.where(pick1, mag * sgn, 0.0),
                    _x.where(pick0 | pick1, 0.0, mag * sgn)))
        jc_n = _norm3(jam_corr)
        move_h = _norm3(_sub3(new_hand, hand0))
        jam_corr = _scale3(
            jam_corr, _x.minimum(1.0, (move_h + 0.0005) / _x.maximum(jc_n, 1e-9)))
        new_hand = _add3(new_hand, jam_corr)
        hand_vel = tuple(_x.div(new_hand[k] - hand0[k], dt) for k in range(3))

        # --- attached objects ride the hand (engine.py:723-786) ---
        att_pos = [_add3(new_hand, attach_off[i]) for i in range(MAX_OBJ)]
        att_support = [_support_z(sc, att_pos[i][0], att_pos[i][1])
                       for i in range(MAX_OBJ)]
        att_z = [_x.maximum(att_pos[i][2], att_support[i] + sc.o_half_h[i])
                 for i in range(MAX_OBJ)]
        tool_prev = _add3(st["obj_pos"][0], _qrot(st["obj_quat"][0], sc.o_tool_off[0]))
        handle_prev = _add3(st["obj_pos"][1], sc.link_handle_off)
        linked_prev = (
            (sc.link_enable > 0)
            & (tool_prev[0] >= handle_prev[0])
            & (_x.abs(tool_prev[1] - handle_prev[1]) <= 0.045)
            & (_x.abs(tool_prev[2] - handle_prev[2]) <= 0.065)
        )
        att_z[0] = att_z[0] + _x.where(
            linked_prev,
            _x.maximum(att_z[0], handle_prev[2] - 0.04) - att_z[0], 0.0)
        for i in range(MAX_OBJ):
            pinned = (attached[i] > 0) & (att_pos[i][2] < att_z[i] - 1e-9)
            off_z_new = _x.where(pinned, att_z[i] - new_hand[2], attach_off[i][2])
            attach_off[i] = (attach_off[i][0], attach_off[i][1], off_z_new)
            att_pos[i] = (att_pos[i][0], att_pos[i][1], att_z[i])
        # climb over shallow walls (engine.py:766-780)
        for i in range(MAX_OBJ):
            climb_vals = []
            for s, (bp, bs) in enumerate(boxes):
                _, n, pen = _sphere_box_pushout(att_pos[i], sc.o_radius[i], bp, bs)
                pen_up = (bp[2] + bs[2] + sc.o_radius[i]) - att_pos[i][2]
                lateral = _x.abs(n[2]) < 0.5
                ok = ((sc.s_exists[s] > 0) & lateral & (pen > 1e-6)
                      & (pen_up > 0.0) & (pen_up < 0.045))
                climb_vals.append(_x.where(ok, _x.minimum(pen_up, 0.0015), 0.0))
            climb = climb_vals[0]
            for cv in climb_vals[1:]:
                climb = _x.maximum(climb, cv)
            climb = climb * attached[i]
            att_pos[i] = (att_pos[i][0], att_pos[i][1], att_pos[i][2] + climb)
            attach_off[i] = (attach_off[i][0], attach_off[i][1],
                             attach_off[i][2] + climb)
        for i in range(MAX_OBJ):
            corr_att = _box_contacts(att_pos[i], sc.o_radius[i])
            corr_att = _scale3(corr_att, (attached[i] > 0))
            att_pos[i] = _add3(att_pos[i], corr_att)
            new_hand = _add3(new_hand, corr_att)
        # attached-tool chain jam (engine.py chain-jam block): a held tool
        # overlapping a body parked beyond its slide range parks the hand
        jam_hx, jam_hy = 0.0, 0.0
        for i_, j_ in ((0, 1), (1, 0)):
            dj = _sub3(att_pos[i_], pos[j_])
            pen_ax_j = tuple(hs_oo[k] - _x.abs(dj[k]) for k in range(3))
            hit_j = (
                (pen_ax_j[0] > 0.0) & (pen_ax_j[1] > 0.0) & (pen_ax_j[2] > 0.0)
                & (attached[i_] > 0) & beyond_range[j_]
                & (sc.o_exists[i_] > 0) & (sc.o_exists[j_] > 0)
                & (sc.link_enable == 0)
            )
            p0, p1, _ = _argmin3(*pen_ax_j)
            dja = _sel3(p0, p1, dj[0], dj[1], dj[2])
            sgn_j = _x.where(dja >= 0.0, 1.0, -1.0)
            mag_j = _x.where(
                hit_j, _sel3(p0, p1, pen_ax_j[0], pen_ax_j[1], pen_ax_j[2]),
                0.0)
            jam_hx = jam_hx + _x.where(p0, mag_j * sgn_j, 0.0)
            jam_hy = jam_hy + _x.where(p1, mag_j * sgn_j, 0.0)
        jam_h3 = (jam_hx, jam_hy, 0.0)
        # grip slip along the jam (engine.py grip-slip block, ~35 mm budget)
        jam_n = _norm3(jam_h3)
        jam_dir = _scale3(jam_h3, 1.0 / _x.maximum(jam_n, 1e-9))
        proj_slip = 0.0
        for i in range(MAX_OBJ):
            proj_slip = proj_slip + (attached[i] > 0) * _dot3(
                attach_off[i], jam_dir)
        slip_g = _x.clip(0.035 - proj_slip, 0.0, jam_n)
        slip_vec = _scale3(jam_dir, slip_g)
        for i in range(MAX_OBJ):
            attach_off[i] = _where3(attached[i] > 0,
                                    _add3(attach_off[i], slip_vec),
                                    attach_off[i])
            att_pos[i] = _where3(attached[i] > 0, _add3(att_pos[i], jam_h3),
                                 att_pos[i])
        new_hand = _add3(new_hand, _sub3(jam_h3, slip_vec))
        for i in range(MAX_OBJ):
            pos[i] = _where3(attached[i] > 0, att_pos[i], pos[i])
            vel[i] = _where3(attached[i] > 0, hand_vel, vel[i])

        # --- rotational dynamics (engine.py:788-833) ---
        quat, omega_out = [], []
        for i in range(MAX_OBJ):
            sz_u = _support_z(sc, pos[i][0], pos[i][1])
            on_ground = (pos[i][2] - sc.o_half_h[i]) <= (sz_u + 1e-4)
            is_sph = sc.is_sphere[i]
            free_rot = (attached[i] == 0) & (sc.o_exists[i] > 0) & ~pinned_anchor[i]
            om = st["obj_angvel"][i]
            inv_r = 1.0 / _x.maximum(sc.o_radius[i], 1e-6)
            roll_w = (-vel[i][1] * inv_r, vel[i][0] * inv_r, 0.0 * vel[i][2])
            om = _where3(is_sph & on_ground & free_rot, roll_w, om)
            om = _where3(~is_sph & on_ground & free_rot, _scale3(om, _OMEGA_DECAY), om)
            keep = free_rot & (sc.o_exists[i] > 0)
            om = tuple(om[k] * keep for k in range(3))
            q = _qintegrate(st["obj_quat"][i], om, dt)
            twist = (q[0], 0.0 * q[1], 0.0 * q[2], q[3])
            tn = _x.sqrt(_x.maximum(_dot4(twist, twist), 1e-24))
            ident = (_x.ones_like(q[0]), 0.0 * q[1], 0.0 * q[2], 0.0 * q[3])
            twist = _where4(tn > 0.05,
                            tuple(t / tn for t in twist), ident)
            righted = _qnlerp(q, twist, _ALPHA_R)
            q = _where4(~is_sph & on_ground & free_rot, righted, q)
            droop_on = _x.where(sc.link_enable > 0,
                                 _x.where(linked_prev, 1.0, 0.0), 1.0)
            theta_eq = sc.o_droop[i] * droop_on
            half = theta_eq / 2.0
            q_droop = (_x.cos(half), 0.0 * half, _x.sin(half), 0.0 * half)
            drooped = _qnlerp(q, q_droop, _ALPHA_D)
            q = _where4(attached[i] > 0, drooped, q)
            quat.append(q)
            omega_out.append(om)

        # --- tool link (engine.py:835-857) ---
        tool_pt = _add3(pos[0], _qrot(quat[0], sc.o_tool_off[0]))
        handle_pt = _add3(pos[1], sc.link_handle_off)
        linked = (
            (sc.link_enable > 0)
            & (tool_pt[0] >= handle_pt[0])
            & (_x.abs(tool_pt[1] - handle_pt[1]) <= 0.040)
            & (_x.abs(tool_pt[2] - handle_pt[2]) <= 0.060)
        )
        dy_link = tool_pt[1] - handle_pt[1]
        corr_link = (
            _x.minimum(tool_pt[0] - handle_pt[0], 0.0),
            dy_link - _x.clip(dy_link, -0.03, 0.03),
            0.0 * dy_link,
        )
        lk = _x.where(linked, 1.0, 0.0)
        pos[1] = _add3(pos[1], _scale3(corr_link, lk))

    else:
        pos = [st["obj_pos"][i] for i in range(MAX_OBJ)]
        vel = [st["obj_vel"][i] for i in range(MAX_OBJ)]
        quat = [st["obj_quat"][i] for i in range(MAX_OBJ)]
        omega_out = [st["obj_angvel"][i] for i in range(MAX_OBJ)]
        attached = [st["attached"][i] for i in range(MAX_OBJ)]
        attach_off = [st["attach_off"][i] for i in range(MAX_OBJ)]
        unanchored = [st["unanchored"][i] for i in range(MAX_OBJ)]
        pad_push_depth = None


    if with_joints:
        # --- fixture free dynamics (engine.py:859-893) ---
        q_free, qv_j, grav_terms = [], [], []
        for j in range(MAX_JOINT):
            qj, qvj = st["joint_q"][j], st["joint_v"][j]
            q_rot = _axquat(sc.j_axis[j], qj)
            com_arm = _qrot(q_rot, sc.j_com[j])
            hinge_d = _cross3(sc.j_axis[j], com_arm)
            dcom_dq_z = _x.where(sc.is_hinge[j], hinge_d[2], sc.j_axis[j][2])
            grav_q = -sc.j_mass[j] * _GRAVITY * dcom_dq_z
            f_ext = (grav_q + sc.j_bias[j]
                     - sc.j_stiffness[j] * (qj - sc.j_springref[j]))
            M_j = _x.maximum(sc.j_inertia[j], 1e-6)
            c_j = sc.j_damping[j]
            decay = sc.j_decay[j]
            qvj = _x.where(
                c_j > 1e-9,
                qvj * decay + (f_ext / _x.maximum(c_j, 1e-9)) * (1.0 - decay),
                qvj + (f_ext / M_j) * dt,
            )
            qv_j.append(qvj)
            q_free.append(qj + qvj * dt)

        handle = [_handle_pos(sc, j, fixture, q_free[j]) for j in range(MAX_JOINT)]
        motion = [_motion_dir(sc, j, q_free[j]) for j in range(MAX_JOINT)]

        # --- hook engage / release (engine.py:904-1000) ---
        tcp_mid = (new_hand[0], new_hand[1], new_hand[2] + PAD_Z_OFFSET * 0.6)
        hooked, hook_off, hook_hoff = [], [], []
        in_claw_j, q_inv_j, gap_perp_j, d_xy_j, d_z_j = [], [], [], [], []
        gap_w = _sub3(target, new_hand)
        for j in range(MAX_JOINT):
            rel_h = _sub3(handle[j], new_hand)
            d_xy = _norm2(rel_h[0], rel_h[1])
            d_z = rel_h[2]
            in_claw = (d_xy < 0.055) & (d_z > -0.06) & (d_z < 0.10)
            q_inv = _fixture_inverse(sc, j, fixture, tcp_mid)
            dq_cap = st["joint_q"][j] - q_inv
            dq_cap = _x.where(
                sc.is_hinge[j],
                _x.mod(dq_cap + _x.pi, 2.0 * _x.pi) - _x.pi,
                dq_cap,
            )
            gp = _sub3(gap_w, _scale3(motion[j], _dot3(gap_w, motion[j])))
            gap_perp_n = _norm3(gp)
            hook_now = (
                (sc.j_hookable[j] > 0)
                & in_claw
                & (_x.abs(dq_cap) <= sc.j_off_cap[j])
                & (effort > 0.0)
                & (gripper < 0.9)
                & (gap_perp_n < _HOOK_SLIP - 0.03)
            )
            newly_hooked = hook_now & (st["hooked"][j] == 0)
            ho = _x.where(newly_hooked, dq_cap, st["hook_off"][j])
            hk = _x.where(hook_now, 1.0, st["hooked"][j])
            q_rot_now = _axquat(sc.j_axis[j], -st["joint_q"][j])
            off_local_now = _qrot(q_rot_now, _sub3(new_hand, handle[j]))
            off_local_now = _where3(sc.is_hinge[j], off_local_now,
                                    _sub3(new_hand, handle[j]))
            hh = _where3(newly_hooked, off_local_now, st["hook_hoff"][j])
            vert = _x.abs(_motion_dir(sc, j, st["joint_q"][j])[2])
            wedge = _x.where((effort > 0.0) & (hk > 0), _WEDGE_A * vert, 0.0)
            ho = ho * (1.0 - wedge)
            # total-stretch rip-off gated on a range stop (engine.py slip)
            at_stop = (st["joint_q"][j] <= sc.j_range[j][0] + 1e-6) | (
                st["joint_q"][j] >= sc.j_range[j][1] - 1e-6
            )
            slip = (gap_perp_n > _HOOK_SLIP) | (
                at_stop & (_norm3(gap_w) > 2.0 * _HOOK_SLIP)
            )
            # a vertical-bar COLLAR never pops off (engine.py collar_j)
            collar = (sc.has_bar[j]
                      & (_x.abs(sc.j_face_dir[j][2]) > 0.9)
                      & (sc.j_face_radius[j] >= 0.06))
            slip = slip & ~collar
            unhook = ((effort <= 0.0) | (d_xy > 0.12) | (d_z < -0.15) | (d_z > 0.2)
                      | slip)
            hk = _x.where(unhook, 0.0, hk) * sc.j_exists[j]
            hooked.append(hk)
            hook_off.append(ho)
            hook_hoff.append(hh)
            in_claw_j.append(in_claw)
            q_inv_j.append(q_inv)
            gap_perp_j.append(gap_perp_n)
            d_xy_j.append(d_xy)
            d_z_j.append(d_z)

        # --- press contacts (engine.py:1002-1257) ---
        knuckle = (new_hand[0], new_hand[1], new_hand[2] + 0.105)
        knuckle_prev = (hand0[0], hand0[1], hand0[2] + 0.105)
        left_prev, right_prev = _pad_centers(hand0, st["gripper"])
        q_rot_free = [_axquat(sc.j_axis[j], q_free[j]) for j in range(MAX_JOINT)]
        press_pt_off = [_qrot(q_rot_free[j], sc.j_press_off[j])
                        for j in range(MAX_JOINT)]
        press_fd = [_qrot(q_rot_free[j], sc.j_face_dir[j]) for j in range(MAX_JOINT)]
        # gate vs the true fully-closed floor (gap = 0.03), see engine.py
        pad_gap = gripper * GRIPPER_FULL_OPEN - PAD_GAP_INSET
        tip_active = _x.clip(_x.div(0.049 - pad_gap, 0.02), 0.0, 1.0)

        def _vel_bounds(j, live, side, center, center_prev, lv, weight):
            vn_q = _x.div(_dot3(_sub3(center, center_prev), motion[j]), dt) / lv
            act = live & (weight > 0.25)
            hi = _x.where(act & (side > 0.0), vn_q, _BIG_QV)
            lo = _x.where(act & (side < 0.0), vn_q, -_BIG_QV)
            return hi, lo

        def sphere_part(j, center, center_prev, r_part, station=None,
                        station_lever=None, weight=1.0, r_face=None):
            pt0 = _add3(handle[j], press_pt_off[j]) if station is None else station
            lv = sc.lever[j] if station_lever is None else station_lever
            face_r = sc.j_handle_radius[j] if r_face is None else r_face
            s_near = _x.clip(_dot3(_sub3(center, pt0), press_fd[j]),
                              -sc.j_face_radius[j], sc.j_face_radius[j])
            pt = _where3(sc.has_bar[j], _add3(pt0, _scale3(press_fd[j], s_near)), pt0)
            d3 = _sub3(center, pt)
            u = _dot3(d3, motion[j])
            u_prev = _dot3(_sub3(center_prev, pt), motion[j])
            side = _x.where(_x.abs(u_prev) > 1e-9, _x.sign(u_prev), _x.sign(u))
            side = _x.where(side == 0.0, 1.0, side)
            perp = _sub3(d3, _scale3(motion[j], u))
            pd = _norm3(perp)
            r_sum = face_r + r_part
            eff_r = _x.where(
                sc.has_bar[j],
                _x.sqrt(_x.maximum(r_sum * r_sum - pd * pd, 1e-24)),
                r_sum,
            )
            in_face = (sc.has_bar[j] & (pd < r_sum)) | (
                ~sc.has_bar[j] & (pd < sc.j_face_radius[j] + 0.6 * r_part))
            pen = eff_r - side * u
            live = in_face & (pen > 0.0) & (side * u > -r_sum)
            du = _dot3(_sub3(center, center_prev), motion[j])
            move_cap = _x.maximum(-side * du, 0.0) + 0.0005
            pen = _x.minimum(pen, move_cap)
            dq_p = weight * _x.where(live, -side * pen, 0.0) / lv
            return (dq_p, *_vel_bounds(j, live, side, center, center_prev, lv, weight))

        def box_part(j, center, center_prev, half, bar_only=False, weight=1.0,
                     disc_yield=False):
            pt0 = _add3(handle[j], press_pt_off[j])
            s_near = _x.clip(_dot3(_sub3(center, pt0), press_fd[j]),
                              -sc.j_face_radius[j], sc.j_face_radius[j])
            pt = _where3(sc.has_bar[j], _add3(pt0, _scale3(press_fd[j], s_near)), pt0)
            d3 = _sub3(center, pt)
            u = _dot3(d3, motion[j])
            u_prev = _dot3(_sub3(center_prev, pt), motion[j])
            side = _x.where(_x.abs(u_prev) > 1e-9, _x.sign(u_prev), _x.sign(u))
            side = _x.where(side == 0.0, 1.0, side)
            h_m = (half[0] * _x.abs(motion[j][0]) + half[1] * _x.abs(motion[j][1])
                   + half[2] * _x.abs(motion[j][2]))
            rel = _sub3(pt, center)
            closest = tuple(_x.clip(rel[k], -half[k], half[k]) for k in range(3))
            gap_vec = tuple(rel[k] - closest[k] for k in range(3))
            gap_lat = _sub3(gap_vec, _scale3(motion[j], _dot3(gap_vec, motion[j])))
            lat_r = _x.where(sc.has_bar[j], sc.j_handle_radius[j],
                              sc.j_face_radius[j])
            lat_ok = _norm3(gap_lat) <= lat_r
            depth = h_m + sc.j_handle_radius[j]
            live = lat_ok & (side * u > -depth)
            if bar_only:
                live = live & sc.has_bar[j]
            pen = depth - side * u
            live = live & (pen > 0.0)
            du = _dot3(_sub3(center, center_prev), motion[j])
            pen = _x.minimum(pen, _x.maximum(-side * du, 0.0) + 0.0005)
            dq_p = weight * _x.where(live, -side * pen, 0.0) / sc.lever[j]
            hi, lo = _vel_bounds(j, live, side, center, center_prev,
                                 sc.lever[j], weight)
            if disc_yield:
                # plate on a horizontal disc cap yields softly: press
                # ratio 0.65, no settle slack, travel-clamped (see
                # engine.py box_part disc_yield)
                rigid = (sc.has_bar[j]
                         | (_x.abs(motion[j][2]) >= 0.5) | sc.is_hinge[j])
                pen_ns = _x.minimum(
                    0.65 * (depth - side * u),
                    _x.maximum(-side * du, 0.0),
                )
                dq_soft = weight * _x.where(live, -side * pen_ns, 0.0) \
                    / sc.lever[j]
                room_lo = _x.minimum(sc.j_range[j][0] - q_free[j], 0.0)
                room_hi = _x.maximum(sc.j_range[j][1] - q_free[j], 0.0)
                dq_soft = _x.clip(dq_soft, room_lo, room_hi)
                soft_press.append(
                    (j, lat_ok & ~rigid
                     & (_x.abs(u) < depth + 0.045)
                     & (sc.j_exists[j] > 0)))
                dq_p = _x.where(rigid, dq_p, dq_soft)
                # spring-back guard: one-sided inelastic bound — the cap
                # cannot move TOWARD a live plate faster than the plate
                # recedes, but is never forced forward (engine.py
                # disc_yield spring-back guard)
                vn_q = _x.div(_dot3(_sub3(center, center_prev), motion[j]),
                              dt) / sc.lever[j]
                live_soft = live & ~rigid
                lo_soft = _x.where(live_soft & (side < 0),
                                    _x.minimum(vn_q, 0.0), -_BIG_QV)
                hi_soft = _x.where(live_soft & (side > 0),
                                    _x.maximum(vn_q, 0.0), _BIG_QV)
                hi = _x.where(rigid, hi, hi_soft)
                lo = _x.where(rigid, lo, lo_soft)
                # face-on jam: hand eject + cap hold, fixed approach side;
                # the eject binds DEEPER than the hold (engine.py
                # disc_yield excess_ej)
                faceon = (~rigid) & (_norm3(gap_lat) < 0.005)
                excess = u - (0.030 - depth)
                excess_ej = u - (0.050 - depth)
                live_j = (faceon & lat_ok & (excess_ej > 0.0) & (u < 0.105)
                          & (sc.j_exists[j] > 0))
                jam_push.append((j, _x.where(live_j, excess_ej, 0.0)))
                # bore-friction ratchet flag, parked plates only
                # (engine.py jam_hold)
                hold = (faceon & lat_ok & (excess > -0.005) & (u < 0.105)
                        & (sc.j_exists[j] > 0))
                jam_hold.setdefault(j, []).append(hold)
                return (dq_p, hi, lo), (_x.zeros_like(dq_p),
                                        _x.full_like(dq_p, _BIG_QV),
                                        _x.full_like(dq_p, -_BIG_QV))
            return (dq_p, hi, lo)

        soft_press = []  # per-lane flags from disc_yield plate parts
        jam_push = []    # (j, per-lane eject depth) from face-on jams
        jam_hold = {}    # j -> per-lane bore-friction ratchet flags
        parts_j = [[] for _ in range(MAX_JOINT)]
        for j in range(MAX_JOINT):
            parts = parts_j[j]
            parts.append(sphere_part(j, new_hand, hand0, 0.012, weight=tip_active))
            ks = sphere_part(j, knuckle, knuckle_prev, 0.012)
            kb = box_part(j, knuckle, knuckle_prev, _KNUCKLE_HALF, bar_only=True)
            parts.append(tuple(_x.where(sc.has_bar[j], b, s)
                               for s, b in zip(ks, kb)))
            left_press, right_press = _pad_centers(new_hand, gripper)
            for _pl in (box_part(j, left_press, left_prev, _PLATE_HALF,
                                 disc_yield=True),
                        box_part(j, right_press, right_prev, _PLATE_HALF,
                                 disc_yield=True)):
                parts.append(_pl[0])
                parts.append(_pl[1])  # face-on jam stop
            rail = (new_hand[0], new_hand[1], new_hand[2] + 0.095)
            rail_prev = (hand0[0], hand0[1], hand0[2] + 0.095)
            # wrist-mesh proxy; off only on horizontal slide disc caps
            # (see engine.py rail_w)
            rail_w = 1.0 - (
                (~sc.has_bar[j]) & (~sc.is_hinge[j])
                & (_x.abs(motion[j][2]) < 0.5)
            ).to(torch.float32)
            parts.append(box_part(j, rail, rail_prev, _RAIL_HALF,
                                  weight=rail_w))
            if with_objects:
                for i in range(MAX_OBJ):
                    tool_i = _add3(pos[i], _qrot(quat[i], sc.o_tool_off[i]))
                    tool_i_prev = _add3(st["obj_pos"][i],
                                        _qrot(st["obj_quat"][i], sc.o_tool_off[i]))
                    parts.append(sphere_part(j, tool_i, tool_i_prev, 0.02,
                                             weight=sc.o_exists[i]))
            # panel stations — CONTINUOUS projection per part (engine.py
            # panel-station block)
            pivot_w = _add3(fixture, sc.j_anchor[j])
            panel_shift = _scale3(motion[j], sc.j_panel_off[j])
            span = _add3(_sub3(handle[j], pivot_w), panel_shift)
            span_n2 = _dot3(span, span)
            for center, center_prev, r_part in (
                (new_hand, hand0, 0.012),
                (knuckle, knuckle_prev, 0.032),
            ):
                fr = _dot3(_sub3(center, pivot_w), span) \
                    / _x.maximum(span_n2, 1e-9)
                fr = _x.clip(fr, 0.3, 0.97)
                station = _add3(pivot_w, _scale3(span, fr))
                st_lever = _x.maximum(sc.lever[j] * fr, 1e-6)
                parts.append(sphere_part(j, center, center_prev, r_part,
                                         station, st_lever,
                                         weight=sc.j_panel[j]))

        dq_j, qv_hi_j, qv_lo_j = [], [], []
        for j in range(MAX_JOINT):
            dq_pos = _x.maximum(parts_j[j][0][0], 0.0)
            dq_neg = _x.minimum(parts_j[j][0][0], 0.0)
            hi = parts_j[j][0][1]
            lo = parts_j[j][0][2]
            for p in parts_j[j][1:]:
                dq_pos = _x.maximum(dq_pos, _x.maximum(p[0], 0.0))
                dq_neg = _x.minimum(dq_neg, _x.minimum(p[0], 0.0))
                hi = _x.minimum(hi, p[1])
                lo = _x.maximum(lo, p[2])
            dq = dq_pos + dq_neg
            # grab suppression (engine.py:1245-1254)
            # hook_carry joints gate on the engage hysteresis (engine.py)
            grabbing = (
                (sc.j_hookable[j] > 0) & in_claw_j[j] & (effort > 0.0)
                & ((sc.j_hook_carry[j] == 0)
                   | (gap_perp_j[j] < _HOOK_SLIP - 0.03))
            )
            dq = _x.where(grabbing, 0.0, dq)
            hi = _x.where(grabbing, _BIG_QV, hi)
            lo = _x.where(grabbing, -_BIG_QV, lo)
            dq = _x.clip(dq, -4.0 * dt / sc.lever[j], 4.0 * dt / sc.lever[j])
            # finite weld load (engine.py:1259-1278)
            gap_n = _x.abs(_dot3(_sub3(target, new_hand), motion[j]))
            dq_budget = _x.where(
                sc.j_damping[j] > 1e-9,
                _WELD_K * gap_n * sc.lever[j] * dt
                / _x.maximum(sc.j_damping[j], 1e-9),
                _BIG_QV,
            ) + 1e-3 * dt
            dq = _x.clip(dq, -dq_budget, dq_budget)
            dq_j.append(dq)
            qv_hi_j.append(hi)
            qv_lo_j.append(lo)

            # hooked drag (engine.py:1279-1303)
            q_target = q_inv_j[j] + hook_off[j]
            dq_hook = q_target - st["joint_q"][j]
            dq_hook = _x.where(
                sc.is_hinge[j],
                _x.mod(dq_hook + _x.pi, 2.0 * _x.pi) - _x.pi,
                dq_hook,
            )
            dq_hook = _x.where(sc.j_hook_carry[j] > 0,
                                _x.maximum(dq_hook, 0.0), dq_hook)
            hook_cap = _x.minimum(4.0 * dt, dq_budget)
            q_hooked = st["joint_q"][j] + _x.clip(dq_hook, -hook_cap, hook_cap)
            q_want = q_free[j] + dq
            q_new = _x.where(hooked[j] > 0, q_hooked, q_want)
            q_new = _x.clip(q_new, sc.j_range[j][0], sc.j_range[j][1])
            # bore-friction ratchet (engine.py jam_hold)
            if j in jam_hold:
                held = jam_hold[j][0]
                for f in jam_hold[j][1:]:
                    held = held | f
                held = held & (hooked[j] == 0)
                q_new = _x.where(held, _x.maximum(q_new, st["joint_q"][j]),
                                  q_new)
            parts_j[j] = (dq, q_new, dq_hook)  # downstream backoff inputs

        # --- stop residual -> hand backoff (engine.py:1305-1334) ---
        backoff = (0.0, 0.0, 0.0)
        residual_j = []
        q_new_j = []
        for j in range(MAX_JOINT):
            dq, q_new, dq_hook = parts_j[j]
            q_free_clip = _x.clip(q_free[j], sc.j_range[j][0], sc.j_range[j][1])
            dq_realized = _x.where(hooked[j] > 0, dq, q_new - q_free_clip)
            residual = (dq - dq_realized) * (hooked[j] == 0) * sc.j_exists[j]
            residual = residual + (
                (dq_hook - (q_new - st["joint_q"][j])) * (hooked[j] > 0)
                * sc.j_exists[j]
            )
            residual_j.append(residual)
            q_new_j.append(q_new)
            backoff = _sub3(backoff, _scale3(motion[j], residual * sc.lever[j]))
        # face-on jam ejects the hand directly (engine.py jam_push)
        jam_by_j = {}
        for j, ex in jam_push:
            jam_by_j[j] = _x.maximum(jam_by_j[j], ex) if j in jam_by_j else ex
        for j, ex in jam_by_j.items():
            backoff = _sub3(backoff, _scale3(motion[j], ex))
        bo_raw = _norm3(backoff)
        move_pre = _norm3(_sub3(new_hand, hand0))
        backoff = _scale3(backoff,
                          _x.minimum(1.0, move_pre / _x.maximum(bo_raw, 1e-9)))
        new_hand = _add3(new_hand, backoff)
        # Coulomb pin against the bottomed-out fixture (engine.py:1336-1358)
        bo_n = _norm3(backoff)
        bo_dir = _scale3(backoff, 1.0 / _x.maximum(bo_n, 1e-9))
        dv_b = _sub3(new_hand, hand0)
        dvbn = _dot3(dv_b, bo_dir)
        dv_bn = _scale3(bo_dir, dvbn)
        dv_bt = _sub3(dv_b, dv_bn)
        bt_mag = _norm3(dv_bt)
        bt_allow = _x.maximum(bt_mag - _MU_HAND * bo_n, 0.0)
        scale_bt = _x.where(bo_n > 1e-9, bt_allow / _x.maximum(bt_mag, 1e-9), 1.0)
        pin_round = (_x.abs(residual_j[0]) > 1e-12) & (sc.j_hookable[0] > 0)
        for j in range(1, MAX_JOINT):
            pin_round = pin_round | (
                (_x.abs(residual_j[j]) > 1e-12) & (sc.j_hookable[j] > 0))
        scale_bt = _x.where(pin_round, 1.0, scale_bt)
        # dome slip on vertically-pressed disc faces (engine.py disc_live)
        any_disc = False
        lat_sum = (0.0, 0.0, 0.0)
        for j in range(MAX_JOINT):
            dl = ((_x.abs(residual_j[j]) > 1e-12) & ~sc.has_bar[j]
                  & (sc.j_hookable[j] == 0) & (sc.j_panel[j] == 0)
                  & (_x.abs(motion[j][2]) > 0.95))
            any_disc = any_disc | dl if not isinstance(any_disc, bool) else dl
            pt_w = _add3(handle[j], press_pt_off[j])
            lv = _sub3(pt_w, new_hand)
            lv = _sub3(lv, _scale3(motion[j], _dot3(lv, motion[j])))
            lat_sum = _add3(lat_sum, _scale3(lv, dl))
        lat_n = _norm3(lat_sum)
        lat_dir = _scale3(lat_sum, 1.0 / _x.maximum(lat_n, 1e-9))
        toward = _dot3(dv_bt, lat_dir)
        dv_bt_disc = _scale3(lat_dir, _x.clip(toward, 0.0, lat_n))
        dv_bt_eff = _where3(any_disc, dv_bt_disc,
                            _scale3(dv_bt, scale_bt))
        new_hand = tuple(hand0[k] + dv_bn[k] + dv_bt_eff[k] for k in range(3))

        # --- rigid handle bars push the claw out (engine.py:1359-1388) ---
        bar_corr = (0.0, 0.0, 0.0)
        for j in range(MAX_JOINT):
            pt0 = _add3(handle[j], press_pt_off[j])
            s_n = _x.clip(_dot3(_sub3(new_hand, pt0), press_fd[j]),
                           -sc.j_face_radius[j], sc.j_face_radius[j])
            pt = _add3(pt0, _scale3(press_fd[j], s_n))
            d3 = _sub3(new_hand, pt)
            dist = _norm3(d3)
            r_sum = sc.j_handle_radius[j] + _HAND_TIP_R
            pen = _x.maximum(r_sum - dist, 0.0)
            n_dir = _scale3(d3, 1.0 / _x.maximum(dist, 1e-9))
            corr = _scale3(n_dir, pen)
            corr = _sub3(corr, _scale3(motion[j], _dot3(corr, motion[j])))
            wrap = (sc.j_hookable[j] > 0) & (
                (hooked[j] > 0) | (in_claw_j[j] & (effort > 0.0)))
            act = sc.has_bar[j] & (sc.j_exists[j] > 0) & ~wrap
            bar_corr = _add3(bar_corr, _scale3(corr, act))
        new_hand = _add3(new_hand, bar_corr)
        # rigid wrap lock (engine.py:1389-1402) + vertical-bar COLLAR
        # (engine.py slide_bar: lateral offset = clamped weld demand, bar
        # axis slides toward the carried equilibrium, cap 0.030)
        lock = (0.0, 0.0, 0.0)
        _COLLAR_CAP = 0.030
        # python floats, NOT the jnp TCP_OFFSET array — a traced-constant
        # array would be captured by the Pallas kernel body
        _TCPO = _TCP_OFFSET_F
        k_bar = _SETTLE  # 1 - exp(-dt / 0.05), the grip time constant
        for j in range(MAX_JOINT):
            q_rot_new = _axquat(sc.j_axis[j], q_new_j[j])
            off_w_new = _qrot(q_rot_new, hook_hoff[j])
            off_w_new = _where3(sc.is_hinge[j], off_w_new, hook_hoff[j])
            handle_new = _handle_pos(sc, j, fixture, q_new_j[j])
            lc = _sub3(_add3(handle_new, off_w_new), new_hand)
            lc = _sub3(lc, _scale3(motion[j], _dot3(lc, motion[j])))
            collar = (sc.has_bar[j]
                      & (_x.abs(sc.j_face_dir[j][2]) > 0.9)
                      & (sc.j_face_radius[j] >= 0.06))
            bar_w = _qrot(q_rot_new, sc.j_face_dir[j])
            off_tgt = _sub3(target, handle_new)
            off_lat = _sub3(off_tgt, _scale3(motion[j], _dot3(off_tgt, motion[j])))
            off_lat = _sub3(off_lat, _scale3(bar_w, _dot3(off_lat, bar_w)))
            lat_n = _norm3(off_lat)
            off_lat = _scale3(off_lat, _x.minimum(
                1.0, _COLLAR_CAP / _x.maximum(lat_n, 1e-9)))
            cc = _sub3(_add3(handle_new, off_lat), new_hand)
            cc = _sub3(cc, _scale3(motion[j], _dot3(cc, motion[j])))
            cc = _sub3(cc, _scale3(bar_w, _dot3(cc, bar_w)))
            bar_des = (target[0] - _TCPO[0],
                       target[1] - _TCPO[1],
                       target[2] - _TCPO[2] - 0.012)
            err_bar = _dot3(_sub3(bar_des, new_hand), bar_w)
            cc = _add3(cc, _scale3(bar_w, err_bar * k_bar))
            lc = _where3(collar, cc, lc)
            lock = _add3(lock, _scale3(lc, (hooked[j] > 0)))
        new_hand = _add3(new_hand, lock)
        # knob-bar support: the claw parks resting on the rotating
        # pointer bar's top (engine.py knob_catch; frictionless,
        # catch-from-above only)
        knob_catch = None
        knob_z = None
        for j in range(MAX_JOINT):
            knob_ok = (sc.is_hinge[j] & (_x.abs(sc.j_axis[j][2]) > 0.9)
                       & (sc.j_hookable[j] == 0) & (sc.j_panel[j] == 0)
                       & (sc.j_handle_radius[j] > 1e-6)
                       & (sc.j_exists[j] > 0))
            piv = _add3(fixture, sc.j_anchor[j])
            hnew = _handle_pos(sc, j, fixture, q_new_j[j])
            dx, dy = hnew[0] - piv[0], hnew[1] - piv[1]
            dn = _x.sqrt(_x.maximum(dx * dx + dy * dy, 1e-18))
            dx, dy = dx / dn, dy / dn
            top = piv[2] + _x.abs(sc.j_arm[j][2]) - 0.004
            lpad_k, rpad_k = _pad_centers(new_hand, gripper)
            for pk in (lpad_k, rpad_k, new_hand):
                rx, ry = pk[0] - piv[0], pk[1] - piv[1]
                proj = rx * dx + ry * dy
                px, py = rx - proj * dx, ry - proj * dy
                over = ((_x.abs(proj) <= 0.061)
                        & (_x.sqrt(_x.maximum(px * px + py * py, 1e-18))
                           <= 0.025))
                c = knob_ok & over & (hand0[2] >= top - 0.005)
                knob_catch = c if knob_catch is None else (knob_catch | c)
                zc = _x.where(c, top, -_x.inf)
                knob_z = zc if knob_z is None else _x.maximum(knob_z, zc)
        if knob_catch is not None:
            new_hand = (new_hand[0], new_hand[1],
                        _x.where(knob_catch,
                                  _x.maximum(new_hand[2], knob_z),
                                  new_hand[2]))

        # --- joint velocities with inelastic press bounds (engine.py:1413-1426) ---
        joint_q_out, joint_v_out = [], []
        for j in range(MAX_JOINT):
            q_new = q_new_j[j]
            qv = _x.div(q_new - st["joint_q"][j], dt)
            cand = _x.clip(qv, qv_lo_j[j], qv_hi_j[j])
            qv_press = _x.where(_x.abs(cand) <= _x.abs(qv) + 1e-9, cand, qv)
            qv = _x.where(hooked[j] > 0, qv, qv_press)
            joint_q_out.append(q_new * sc.j_exists[j])
            joint_v_out.append(qv * sc.j_exists[j])

        # finger yield under a soft plate press, gated on the weld stretch
        # along the press axis (engine.py: aperture tracks the loaded
        # plateau under a HARD press; the finger ODE reopens on release)
        if soft_press:
            soft_any = None
            for j, f in soft_press:
                gap_n_j = _x.abs(_dot3(_sub3(target, new_hand), motion[j]))
                fj = f & (gap_n_j > 0.06)
                soft_any = fj if soft_any is None else (soft_any | fj)
            loaded_cap = _x.maximum(st["gripper"] - 0.0025, 0.696)
            gripper = _x.where(
                soft_any, _x.minimum(gripper, loaded_cap), gripper,
            )

    else:
        joint_q_out = [st["joint_q"][j] for j in range(MAX_JOINT)]
        joint_v_out = [st["joint_v"][j] for j in range(MAX_JOINT)]
        hooked = [st["hooked"][j] for j in range(MAX_JOINT)]
        hook_off = [st["hook_off"][j] for j in range(MAX_JOINT)]
        hook_hoff = [st["hook_hoff"][j] for j in range(MAX_JOINT)]

    # table support under the claw with the Coulomb stick/slip pin
    # (engine.py table-support block) — moved after the joint-velocity
    # block (order-independent: that block does not read new_hand), so
    # the support also applies when with_joints is False
    tbl = _support_z(sc, new_hand[0], new_hand[1]) - 0.010
    blocked_z = _x.maximum(tbl - new_hand[2], 0.0)
    dv_sx = new_hand[0] - hand0[0]
    dv_sy = new_hand[1] - hand0[1]
    t_mag_s = _x.sqrt(_x.maximum(dv_sx * dv_sx + dv_sy * dv_sy, 1e-24))
    t_allow_s = _x.maximum(t_mag_s - _MU_TABLE * blocked_z, 0.0)
    scale_s = _x.where(blocked_z > 1e-9,
                        t_allow_s / _x.maximum(t_mag_s, 1e-9), 1.0)
    new_hand = (hand0[0] + dv_sx * scale_s, hand0[1] + dv_sy * scale_s,
                new_hand[2] + blocked_z)
    hand_vel = tuple(_x.div(new_hand[k] - hand0[k], dt) for k in range(3))


    # --- pad forces (engine.py:1428-1438) ---
    if with_objects:
        gripped0 = ((attached[0] > 0) | can_grasp[0]) & (squeeze > 0.0)
        pad_f_l = (_PAD_K * pad_push_depth[0][0]
                   + _x.where(gripped0, squeeze, 0.0))
        pad_f_r = (_PAD_K * pad_push_depth[1][0]
                   + _x.where(gripped0, squeeze, 0.0))
    else:
        pad_f_l = _x.zeros_like(gripper)
        pad_f_r = _x.zeros_like(gripper)

    return {
        "hand": new_hand,
        "hand_vel": hand_vel,
        "gripper": gripper,
        "gripper_vel": gripper_vel,
        "obj_pos": pos,
        "obj_quat": quat,
        "obj_vel": vel,
        "obj_angvel": omega_out,
        "joint_q": joint_q_out,
        "joint_v": joint_v_out,
        "attached": attached,
        "attach_off": attach_off,
        "unanchored": unanchored,
        "hooked": hooked,
        "hook_off": hook_off,
        "hook_hoff": hook_hoff,
        "pad_force_l": pad_f_l,
        "pad_force_r": pad_f_r,
        "fixture_pos": st["fixture_pos"],
    }


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def weld_target(sim_mocap, action, mocap_low, mocap_high):
    """Action -> (clipped mocap, weld target xyz lanes, grip effort lane):
    the part of the control step that runs once before the substeps
    (engine_lanes.py:1687-1695 of the JAX package)."""
    a = torch.clamp(action[..., :3], -1.0, 1.0)
    mocap = torch.minimum(torch.maximum(sim_mocap + a * ACTION_SCALE, mocap_low),
                          mocap_high)
    effort = action[..., 3]
    target_arr = engine._vec3(mocap, engine.TCP_OFFSET) + reach_target_delta(mocap)
    return mocap, target_arr, effort


def run_substeps(sc, sim: SimState, target, effort, mocap, **flags) -> SimState:
    """FRAME_SKIP substeps from `sim` with the weld target held fixed."""
    st = sim_lanes(sim)
    tgt = _v3(target)
    for _ in range(FRAME_SKIP):
        st = _substep(sc, st, tgt, effort, **flags)
    pad_l, pad_r = _pad_centers(st["hand"], st["gripper"])
    pads = (_stack_last(pad_l), _stack_last(pad_r))
    return lanes_to_sim(st, mocap, pads)


def control_step(scene: SceneParams, sim: SimState, action) -> SimState:
    """One 12.5 ms control step over a batch: `scene` holds (N, ...) per-slot
    rows, `sim` (N, ...) state, `action` (N, 4)."""
    mocap, target, effort = weld_target(sim.mocap, action, scene.mocap_low,
                                        scene.mocap_high)
    return run_substeps(scene_lanes(scene), sim, target, effort, mocap)
