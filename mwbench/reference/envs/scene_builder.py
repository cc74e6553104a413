# Frozen copy of metaworld_tpu_torch/envs/scene_builder.py at commit 3742bce; imports renamed.
"""Declarative scene construction (numpy), copied from the JAX package's
`envs/scene_builder.py` so the port builds bit-identical scene rows.

Original summary: the MJCF-compiler equivalent.

The reference compiles 38 MJCF scene files through MuJoCo's model compiler at
env construction (ref sawyer_xyz_env.py:221-229 -> MujocoEnv). Here each task
declares its scene with these helpers; the result is a `SceneParams` row of
plain numpy arrays. All 50 rows stack into device-resident tables so a single
jitted step serves any mix of tasks (gather by task id).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mwbench.reference.types import (
    MAX_JOINT,
    MAX_OBJ,
    MAX_STATIC,
    JointType,
    ObjType,
    SceneParams,
    tree_map,
)


@dataclasses.dataclass
class FreeObj:
    """A dynamic free body (puck, ball, block, tool)."""

    kind: int = ObjType.CYLINDER
    radius: float = 0.02        # horizontal contact radius
    half_x: float = 0.0         # x half-extent for pad contacts (0 -> radius);
                                # set for rods lying along x (stick: box geom
                                # half 0.05, ref objects/assets/stick.xml)
    oo_half_x: float = 0.0      # x half-extent for object-object contact
                                # (0 -> half_x): the stick-push container's
                                # handle rod reaches past its pad-contact body
    half_h: float = 0.02        # COM height above support when resting
    mass: float = 0.1
    graspable: bool = True
    grasp_halfwidth: float = 0.02  # y half-width the pads clamp onto
    anchored: bool = False      # held in place (socketed) until first grasped
    hook_grasp: bool = False    # the claw catches a geometric feature (plug end
                                # cap): attaches when caged with the grip driving
                                # closed, no squeeze contact required (the ref
                                # peg-unplug drags the plug at grip ~0.88, pads
                                # 13 mm clear of the shaft)
    tool_off: tuple = (0.0, 0.0, 0.0)  # tool point rel. COM (hammer head, stick tip)
    grasp_off: tuple = (0.0, 0.0, 0.0)  # grasp point rel. COM (handles, knobs)
    droop: float = 0.0  # equilibrium in-grip pitch about the pad axis (rad)
    planar: bool = False  # 2-dof slide body in the reference: no lift, no gravity
    lin_damping: float = 0.0  # planar slide joint damping (N·s/m)
    xy_range: tuple = ()    # absolute world (lo_x, lo_y, hi_x, hi_y) soft
                            # slide-joint limits (plate-slide puck: 2 limited
                            # slides, ref objects/assets/puck.xml); () = free
    friction: float = 0.55  # sliding Coulomb coefficient on the support
                            # (MuJoCo's default mu is 1.0 — e.g. the soccer
                            # ball, soccer_dependencies.xml condim=3)
    grasp_x_tol: float = 0.0  # max |x| offset of the grasp point from the
                            # tcp for a STABLE cage (0 -> the engine default
                            # 0.035). The tapered coffee mug wedges out of
                            # any off-diameter pinch (golden coffee-push:
                            # the claw squeezes at dx 15-42 mm and the mug
                            # squirts out along the pad axis; coffee-pull's
                            # stable grasp is centered to 2 mm)


@dataclasses.dataclass
class FixtureJoint:
    """A 1-dof articulated fixture (door hinge, drawer slide, button, ...)."""

    kind: int = JointType.SLIDE
    axis: tuple = (0.0, 0.0, 1.0)      # slide direction / hinge axis
    anchor: tuple = (0.0, 0.0, 0.0)    # handle rest pos (slide) / pivot (hinge), rel. fixture base
    arm: tuple = (0.0, 0.0, 0.0)       # hinge: handle offset from pivot at q=0
    range: tuple = (0.0, 1.0)
    damping: float = 2.0
    stiffness: float = 0.0
    springref: float = 0.0
    inertia: float = 0.1
    bias: float = 0.0                  # constant generalized force (actuator bias)
    mass: float = 0.0                  # subtree mass (kg) — gravity force source
    com: tuple = (0.0, 0.0, 0.0)       # subtree COM rel. anchor at q=0
    handle_radius: float = 0.02
    face_radius: float = 0.0           # lateral press-face radius (0 -> handle_radius)
    press_off: tuple = (0.0, 0.0, 0.0)  # press-face center offset from the handle point
    face_dir: tuple = (0.0, 0.0, 0.0)  # bar axis: zero = disc face; set = capsule
                                       # (radius handle_radius, half-len face_radius)
    hookable: bool = False             # gripper can close on handle and pull
    hook_carry: bool = False           # the handle only RESTS on the claw (a
                                       # ball too big for the mouth): the hook
                                       # transmits +q lifts only, never drags
                                       # the joint back down
    panel: bool = False                # hinge carries a panel (press along the arm span)
    panel_off: float = 0.0             # panel plane offset from the pivot->handle
                                       # line along +motion (door handles stick out
                                       # in front of the panel)


@dataclasses.dataclass
class StaticBox:
    pos: tuple = (0.0, 0.0, 0.0)
    size: tuple = (0.05, 0.05, 0.05)
    rel_fixture: bool = False          # positioned relative to fixture base
    blocks_hand: bool = True           # the gripper collides with this box


def build_scene(
    objs: list[FreeObj] = (),
    joints: list[FixtureJoint] = (),
    boxes: list[StaticBox] = (),
    hole_center=(0.0, 0.0),
    hole_halfsize=(0.0, 0.0),
    pit_depth=0.0,
    table_z=0.0,
    mocap_low=(-0.2, 0.55, 0.05),
    mocap_high=(0.2, 0.75, 0.3),
    link_enable=False,
    link_handle_off=(0.0, 0.0, 0.0),
) -> SceneParams:
    """Assemble a SceneParams row (numpy, unbatched) with padding."""
    assert len(objs) <= MAX_OBJ and len(joints) <= MAX_JOINT and len(boxes) <= MAX_STATIC

    def pad(rows, n, width=None):
        rows = list(rows)
        out = np.zeros((n,) if width is None else (n, width))
        for i, r in enumerate(rows):
            out[i] = r
        return out

    o = list(objs)
    j = list(joints)
    b = list(boxes)
    f = np.float64
    return SceneParams(
        obj_exists=pad([1.0] * len(o), MAX_OBJ).astype(f),
        obj_type=pad([x.kind for x in o], MAX_OBJ).astype(np.int32),
        obj_radius=pad([x.radius for x in o], MAX_OBJ).astype(f),
        obj_half_x=pad([x.half_x or x.radius for x in o], MAX_OBJ).astype(f),
        obj_oo_half_x=pad([x.oo_half_x or x.half_x or x.radius for x in o],
                          MAX_OBJ).astype(f),
        obj_half_h=pad([x.half_h for x in o], MAX_OBJ).astype(f),
        obj_mass=pad([x.mass for x in o], MAX_OBJ).astype(f),
        obj_graspable=pad([float(x.graspable) for x in o], MAX_OBJ).astype(f),
        obj_grasp_halfwidth=pad([x.grasp_halfwidth for x in o], MAX_OBJ).astype(f),
        obj_anchored=pad([float(x.anchored) for x in o], MAX_OBJ).astype(f),
        obj_tool_off=pad([x.tool_off for x in o], MAX_OBJ, 3).astype(f),
        obj_droop=pad([x.droop for x in o], MAX_OBJ).astype(f),
        obj_grasp_off=pad([x.grasp_off for x in o], MAX_OBJ, 3).astype(f),
        obj_planar=pad([float(x.planar) for x in o], MAX_OBJ).astype(f),
        obj_lin_damping=pad([x.lin_damping for x in o], MAX_OBJ).astype(f),
        obj_friction=pad([x.friction for x in o], MAX_OBJ).astype(f),
        obj_xy_limited=pad([float(bool(x.xy_range)) for x in o], MAX_OBJ).astype(f),
        obj_xy_lo=pad([(x.xy_range[:2] if x.xy_range else (0.0, 0.0)) for x in o], MAX_OBJ, 2).astype(f),
        obj_xy_hi=pad([(x.xy_range[2:] if x.xy_range else (0.0, 0.0)) for x in o], MAX_OBJ, 2).astype(f),
        obj_hook_grasp=pad([float(x.hook_grasp) for x in o], MAX_OBJ).astype(f),
        obj_grasp_x_tol=pad([x.grasp_x_tol or 0.035 for x in o],
                            MAX_OBJ).astype(f),
        link_enable=np.asarray(float(link_enable), dtype=f),
        link_handle_off=np.asarray(link_handle_off, dtype=f),
        joint_exists=pad([1.0] * len(j), MAX_JOINT).astype(f),
        joint_type=pad([x.kind for x in j], MAX_JOINT).astype(np.int32),
        joint_axis=pad([x.axis for x in j], MAX_JOINT, 3).astype(f),
        joint_anchor=pad([x.anchor for x in j], MAX_JOINT, 3).astype(f),
        joint_arm=pad([x.arm for x in j], MAX_JOINT, 3).astype(f),
        joint_range=pad([x.range for x in j], MAX_JOINT, 2).astype(f),
        joint_damping=pad([x.damping for x in j], MAX_JOINT).astype(f),
        joint_stiffness=pad([x.stiffness for x in j], MAX_JOINT).astype(f),
        joint_springref=pad([x.springref for x in j], MAX_JOINT).astype(f),
        joint_inertia=pad([max(x.inertia, 1e-4) for x in j], MAX_JOINT).astype(f),
        joint_bias=pad([x.bias for x in j], MAX_JOINT).astype(f),
        joint_mass=pad([x.mass for x in j], MAX_JOINT).astype(f),
        joint_com=pad([x.com for x in j], MAX_JOINT, 3).astype(f),
        joint_handle_radius=pad([x.handle_radius for x in j], MAX_JOINT).astype(f),
        joint_face_radius=pad(
            [x.face_radius or x.handle_radius for x in j], MAX_JOINT
        ).astype(f),
        joint_press_off=pad([x.press_off for x in j], MAX_JOINT, 3).astype(f),
        joint_face_dir=pad([x.face_dir for x in j], MAX_JOINT, 3).astype(f),
        joint_hookable=pad([float(x.hookable) for x in j], MAX_JOINT).astype(f),
        joint_hook_carry=pad([float(x.hook_carry) for x in j], MAX_JOINT).astype(f),
        joint_panel=pad([float(x.panel) for x in j], MAX_JOINT).astype(f),
        joint_panel_off=pad([x.panel_off for x in j], MAX_JOINT).astype(f),
        static_exists=pad([1.0] * len(b), MAX_STATIC).astype(f),
        static_pos=pad([x.pos for x in b], MAX_STATIC, 3).astype(f),
        static_size=pad([x.size for x in b], MAX_STATIC, 3).astype(f),
        static_rel=pad([float(x.rel_fixture) for x in b], MAX_STATIC).astype(f),
        static_blocks_hand=pad([float(x.blocks_hand) for x in b],
                               MAX_STATIC).astype(f),
        hole_center=np.asarray(hole_center, dtype=f),
        hole_halfsize=np.asarray(hole_halfsize, dtype=f),
        pit_depth=np.asarray(pit_depth, dtype=f),
        table_z=np.asarray(table_z, dtype=f),
        mocap_low=np.asarray(mocap_low, dtype=f),
        mocap_high=np.asarray(mocap_high, dtype=f),
    )


def stack_scenes(scenes: list[SceneParams]) -> SceneParams:
    """Stack per-task rows into (n_tasks, ...) tables."""
    return tree_map(lambda *xs: np.stack(xs, axis=0), *scenes)
