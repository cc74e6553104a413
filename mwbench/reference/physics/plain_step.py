# Frozen copy of metaworld_tpu_torch/physics/cuda_step.py (without the kernel wrapper) at commit 3742bce; imports renamed.
"""The physics control step in plain PyTorch: the lane layout of the
kernel's packed rows, the per-task scene table, the variants and
`plain_control_step`, the kernel's plain version (all feature families
on for every env). The kernel library, its block table and its launch
are left out of this copy: the reference never runs the kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mwbench.reference.physics import engine_lanes
from mwbench.reference.physics.engine_lanes import _NS
from mwbench.reference.types import (
    MAX_JOINT, MAX_OBJ, MAX_STATIC, SceneParams, SimState)

# ---------------------------------------------------------------------------
# lane-layout specs: (name, kind, count, as_bool), as pallas_step._SC_SPEC /
# _SIM_SPEC; csrc/substep.cuh's ScRow / SimRow enums are these row offsets
# ---------------------------------------------------------------------------

SC_SPEC = [
    ("o_exists", "ls", MAX_OBJ, False),
    ("o_type", "ls", MAX_OBJ, False),
    ("o_radius", "ls", MAX_OBJ, False),
    ("o_half_x", "ls", MAX_OBJ, False),
    ("o_oo_half_x", "ls", MAX_OBJ, False),
    ("o_grasp_x_tol", "ls", MAX_OBJ, False),
    ("o_half_h", "ls", MAX_OBJ, False),
    ("o_graspable", "ls", MAX_OBJ, False),
    ("o_ghw", "ls", MAX_OBJ, False),
    ("o_anchored", "ls", MAX_OBJ, False),
    ("o_tool_off", "lv3", MAX_OBJ, False),
    ("o_droop", "ls", MAX_OBJ, False),
    ("o_grasp_off", "lv3", MAX_OBJ, False),
    ("o_planar", "ls", MAX_OBJ, True),
    ("o_xy_limited", "ls", MAX_OBJ, False),
    ("o_xy_lo", "lv2", MAX_OBJ, False),
    ("o_xy_hi", "lv2", MAX_OBJ, False),
    ("o_hookg", "ls", MAX_OBJ, False),
    ("link_enable", "s", 1, False),
    ("link_handle_off", "v3", 1, False),
    ("j_exists", "ls", MAX_JOINT, False),
    ("j_axis", "lv3", MAX_JOINT, False),
    ("j_anchor", "lv3", MAX_JOINT, False),
    ("j_arm", "lv3", MAX_JOINT, False),
    ("j_range", "lv2", MAX_JOINT, False),
    ("j_damping", "ls", MAX_JOINT, False),
    ("j_stiffness", "ls", MAX_JOINT, False),
    ("j_springref", "ls", MAX_JOINT, False),
    ("j_inertia", "ls", MAX_JOINT, False),
    ("j_bias", "ls", MAX_JOINT, False),
    ("j_mass", "ls", MAX_JOINT, False),
    ("j_com", "lv3", MAX_JOINT, False),
    ("j_handle_radius", "ls", MAX_JOINT, False),
    ("j_face_radius", "ls", MAX_JOINT, False),
    ("j_press_off", "lv3", MAX_JOINT, False),
    ("j_face_dir", "lv3", MAX_JOINT, False),
    ("j_hook_carry", "ls", MAX_JOINT, False),
    ("j_hookable", "ls", MAX_JOINT, False),
    ("j_panel_off", "ls", MAX_JOINT, False),
    ("j_panel", "ls", MAX_JOINT, False),
    ("s_exists", "ls", MAX_STATIC, False),
    ("s_pos", "lv3", MAX_STATIC, False),
    ("s_size", "lv3", MAX_STATIC, False),
    ("s_rel", "ls", MAX_STATIC, False),
    ("hole_c", "v2", 1, False),
    ("hole_h", "v2", 1, False),
    ("pit_depth", "s", 1, False),
    ("table_z", "s", 1, False),
    ("is_sphere", "ls", MAX_OBJ, True),
    ("is_hinge", "ls", MAX_JOINT, True),
    ("blk", "ls", MAX_STATIC, False),
    ("has_bar", "ls", MAX_JOINT, True),
    ("lever", "ls", MAX_JOINT, False),
    ("visc", "ls", MAX_OBJ, False),
    ("blend", "ls", MAX_OBJ, False),
    ("fric", "ls", MAX_OBJ, False),
    ("sphere_dn", "ls", MAX_OBJ, False),
    ("j_decay", "ls", MAX_JOINT, False),
    ("j_off_cap", "ls", MAX_JOINT, False),
]

SIM_SPEC = [
    ("hand", "v3", 1, False),
    ("hand_vel", "v3", 1, False),
    ("gripper", "s", 1, False),
    ("gripper_vel", "s", 1, False),
    ("obj_pos", "lv3", MAX_OBJ, False),
    ("obj_quat", "lv4", MAX_OBJ, False),
    ("obj_vel", "lv3", MAX_OBJ, False),
    ("obj_angvel", "lv3", MAX_OBJ, False),
    ("joint_q", "ls", MAX_JOINT, False),
    ("joint_v", "ls", MAX_JOINT, False),
    ("attached", "ls", MAX_OBJ, False),
    ("attach_off", "lv3", MAX_OBJ, False),
    ("unanchored", "ls", MAX_OBJ, False),
    ("hooked", "ls", MAX_JOINT, False),
    ("hook_off", "ls", MAX_JOINT, False),
    ("hook_hoff", "lv3", MAX_JOINT, False),
    ("pad_force_l", "s", 1, False),
    ("pad_force_r", "s", 1, False),
    ("fixture_pos", "v3", 1, False),
]

_TUP = {"v2": 2, "v3": 3, "lv2": 2, "lv3": 3, "lv4": 4}


def _field_rows(kind, count):
    if kind == "s":
        return 1
    if kind in ("v2", "v3"):
        return _TUP[kind]
    if kind == "ls":
        return count
    return count * _TUP[kind]


def spec_offsets(spec) -> dict:
    """name -> first row of the field."""
    out, r = {}, 0
    for name, kind, count, _ in spec:
        out[name] = r
        r += _field_rows(kind, count)
    return out


SC_ROWS = sum(_field_rows(k, c) for _, k, c, _ in SC_SPEC)
SIM_ROWS = sum(_field_rows(k, c) for _, k, c, _ in SIM_SPEC)


def _emit_lanes(spec, get):
    for name, kind, count, _ in spec:
        v = get(name)
        if kind == "s":
            yield v
        elif kind in ("v2", "v3"):
            yield from v
        elif kind == "ls":
            for i in range(count):
                yield v[i]
        else:
            for i in range(count):
                yield from v[i]


def _build_lanes(rows, spec) -> dict:
    """Rows (R, N) -> the lane containers of `spec` (bool rows as bools)."""
    it = iter(rows)
    out = {}
    for name, kind, count, as_bool in spec:
        conv = (lambda x: x != 0.0) if as_bool else (lambda x: x)
        if kind == "s":
            out[name] = conv(next(it))
        elif kind in ("v2", "v3"):
            out[name] = tuple(conv(next(it)) for _ in range(_TUP[kind]))
        elif kind == "ls":
            out[name] = [conv(next(it)) for _ in range(count)]
        else:
            out[name] = [tuple(conv(next(it)) for _ in range(_TUP[kind]))
                         for _ in range(count)]
    return out


def pack_scene_rows(scene: SceneParams) -> torch.Tensor:
    """Batched SceneParams tensors (N, ...) -> (SC_ROWS, N) float32."""
    sc = engine_lanes.scene_lanes(scene)
    return torch.stack([x.to(torch.float32) for x in
                        _emit_lanes(SC_SPEC, lambda n: getattr(sc, n))])


def pack_sim_rows(sim: SimState) -> torch.Tensor:
    """SimState (N, ...) -> (SIM_ROWS, N) float32."""
    st = engine_lanes.sim_lanes(sim)
    return torch.stack([x.to(torch.float32) for x in
                        _emit_lanes(SIM_SPEC, lambda n: st[n])])


def unpack_sim_rows(rows: torch.Tensor, mocap) -> SimState:
    st = _build_lanes(rows, SIM_SPEC)
    pad_l, pad_r = engine_lanes._pad_centers(st["hand"], st["gripper"])
    pads = (engine_lanes._stack_last(pad_l), engine_lanes._stack_last(pad_r))
    return engine_lanes.lanes_to_sim(st, mocap, pads)


# ---------------------------------------------------------------------------
# the per-task scene table, the variants and the block table
# ---------------------------------------------------------------------------

BLOCK = 128  # CUDA threads per block (kThreads in step_kernel.cu)

# (with_objects, with_joints, with_hand_boxes) per variant id
VARIANTS = (
    dict(with_objects=True, with_joints=False, with_hand_boxes=False),
    dict(with_objects=True, with_joints=False, with_hand_boxes=True),
    dict(with_objects=False, with_joints=True, with_hand_boxes=True),
    dict(with_objects=True, with_joints=True, with_hand_boxes=True),
)


@dataclasses.dataclass
class SceneTable:
    """Per-task scene rows on one device."""

    rows: torch.Tensor        # (n_tasks, SC_ROWS) float32
    mocap_low: torch.Tensor   # (n_tasks, 3)
    mocap_high: torch.Tensor  # (n_tasks, 3)
    features: np.ndarray      # (n_tasks, 3) bool: objects, joints, hand boxes


def scene_features(scene: SceneParams) -> np.ndarray:
    """(..., 3) bool: has objects, has joints, has hand-blocking boxes."""
    obj = np.asarray(scene.obj_exists).any(axis=-1)
    joint = np.asarray(scene.joint_exists).any(axis=-1)
    blk = (np.asarray(scene.static_exists)
           * np.asarray(scene.static_blocks_hand)).any(axis=-1)
    return np.stack([obj, joint, blk], axis=-1)


def build_scene_table(scenes, device) -> SceneTable:
    """Table of per-task scene rows from unbatched numpy SceneParams."""
    from mwbench.reference.envs.scene_builder import stack_scenes
    from mwbench.reference.types import tree_map

    stacked = stack_scenes(list(scenes))
    t = tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.int32 if a.dtype.kind == "i" else np.float32)), stacked)
    rows = pack_scene_rows(t).T.contiguous()
    return SceneTable(rows=rows.to(device),
                      mocap_low=t.mocap_low.to(device),
                      mocap_high=t.mocap_high.to(device),
                      features=scene_features(stacked))


def block_variants(features: np.ndarray, block: int = BLOCK) -> tuple:
    """Variant id of each block of `block` envs from per-env features
    (N, 3). A variant is sound only where the features it drops are absent
    for every env in the block (pallas_step.block_variants' rule; the ragged
    last block is masked in the kernel, not padded)."""
    n = features.shape[0]
    ids = []
    for b in range(-(-n // block)):
        f = features[b * block:(b + 1) * block].any(axis=0)
        o, j, k = bool(f[0]), bool(f[1]), bool(f[2])
        ids.append((3 if o else 2) if j else (1 if k else 0))
    return tuple(ids)


def variant_runs(variants, n: int, block: int = BLOCK) -> list:
    """Same-variant runs of blocks as (variant, first env, env count)."""
    runs = []
    for b, v in enumerate(variants):
        if runs and runs[-1][0] == v:
            runs[-1][2] += block
        else:
            runs.append([v, b * block, block])
    out = [(v, s, min(c, n - s)) for v, s, c in runs]
    return out


def _sim_and_ctl(table: SceneTable, task_ids, sim: SimState, action):
    ids = task_ids.long()
    mocap, target, effort = engine_lanes.weld_target(
        sim.mocap, action, table.mocap_low[ids], table.mocap_high[ids])
    return mocap, target, effort


def plain_control_step(table: SceneTable, task_ids, sim: SimState,
                       action) -> SimState:
    """The kernel's plain PyTorch version: the same control step through
    engine_lanes on scene lanes gathered from the table (all features on)."""
    mocap, target, effort = _sim_and_ctl(table, task_ids, sim, action)
    rows = table.rows[task_ids.long()].T
    sc = _NS(**_build_lanes(rows, SC_SPEC))
    return engine_lanes.run_substeps(sc, sim, target, effort, mocap)
