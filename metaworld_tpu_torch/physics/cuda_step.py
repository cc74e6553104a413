"""The physics control step on the GPU: wrapper of the hand-written CUDA
kernel (`csrc/step_kernel.cu`, `csrc/block_step.cuh`, `csrc/substep.cuh`).

Replaces the Pallas TPU kernel of the JAX package,
`metaworld_tpu/physics/pallas_step.py` (`_make_kernel` built as
`_step_kernel_v0..v3`, launched per same-variant run by `control_step`).

What bounds it on an H100: operations. Per env and control step the kernel
moves about 524 bytes (63 state floats in and out, 4 control floats, one
task id; the scene rows come from a per-task table), while FRAME_SKIP
substeps of the lane engine are a few thousand float32 operations. What the
design does about it: one thread per env over the packed (SIM_ROWS, N)
state rows (coalesced loads and stores), a per-task scene table instead of
198 streamed rows per env, and one launch per control step over a block
table (`block_table`): each 128-env block runs the one of four template
instantiations that drops the feature families its envs lack, and the
blocks of all four variants share the SMs, heaviest variant first. See
PERF.md for registers, occupancy and times.

`control_step` launches the kernel for CUDA tensors (no fallback; a failed
launch raises) and runs the plain PyTorch version, `plain_control_step`,
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from metaworld_tpu_torch.physics import engine_lanes
from metaworld_tpu_torch.physics.engine_lanes import _NS
from metaworld_tpu_torch.types import (
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
    from metaworld_tpu_torch.envs.scene_builder import stack_scenes
    from metaworld_tpu_torch.types import tree_map

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


BLOCK_COLS = 5  # block-table columns (csrc/block_step.cuh BlockCol)


@dataclasses.dataclass
class BlockTable:
    """The block table of one launch: one int32 row per block of `block`
    envs, (variant, first env, env count, first task id, number of task
    ids), heaviest variant first. `rows` lives on the launch's device;
    `host` is the same table in numpy, where the wrapper reads sizes and
    counts without touching the device."""

    rows: torch.Tensor   # (n_blocks, BLOCK_COLS) int32
    host: np.ndarray     # (n_blocks, BLOCK_COLS) int32
    n: int               # envs of the batch the rows index
    block: int

    def __post_init__(self):
        h = self.host
        self.blocks_by_variant = [int((h[:, 0] == v).sum()) for v in range(4)]
        # one past the greatest task id the blocks read
        self.task_end = int((h[:, 3] + h[:, 4]).max(initial=0))

    def select(self, keep) -> "BlockTable":
        """The table of the rows where `keep` (a mask or indices) holds."""
        host = np.ascontiguousarray(self.host[keep])
        return BlockTable(torch.from_numpy(host).to(self.rows.device), host,
                          self.n, self.block)


def block_table(task_ids, task_features: np.ndarray, block: int = BLOCK,
                device="cpu") -> BlockTable:
    """Block table of N envs from their task ids (N,) and the per-task
    features (n_tasks, 3): each block's variant is `block_variants`' over
    its envs, its task range the least and greatest task id among them.
    Rows are ordered heaviest variant first (v3, v2, v1, v0: the variants'
    operation counts rise with the id), blocks in order within a variant."""
    ids = np.asarray(task_ids, dtype=np.int64)
    n = ids.shape[0]
    variants = np.asarray(block_variants(task_features[ids], block), np.int64)
    first = np.arange(variants.shape[0]) * block
    lo = np.minimum.reduceat(ids, first) if n else first
    hi = np.maximum.reduceat(ids, first) if n else first
    host = np.stack([variants, first, np.minimum(block, n - first), lo,
                     hi - lo + 1], axis=1).astype(np.int32)
    host = np.ascontiguousarray(host[np.argsort(-variants, kind="stable")])
    return BlockTable(torch.from_numpy(host).to(device), host, n, block)


# ---------------------------------------------------------------------------
# the kernel library and the wrapper
# ---------------------------------------------------------------------------

launches = 0                       # kernel launches made by launch_rows
launches_by_variant = [0, 0, 0, 0]  # of those, the ones that ran the variant
blocks_by_variant = [0, 0, 0, 0]    # blocks run per variant

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the kernel library's C interface on `lib`."""
    lib.mw_step.restype = ctypes.c_int
    lib.mw_step.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    lib.mw_step_info.restype = ctypes.c_int
    lib.mw_step_info.argtypes = [ctypes.c_void_p] * 4
    return lib


def _load():
    global _lib
    if _lib is None:
        from metaworld_tpu_torch.physics import _build

        _lib = bind(ctypes.CDLL(str(_build.build_cuda())))
    return _lib


def kernel_info(lib=None) -> dict:
    """Registers and local (stack and spill) bytes per thread of the built
    kernel, its shared memory per block, and the blocks an SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = lib or _load()
    vals = [ctypes.c_int(0) for _ in range(4)]
    err = lib.mw_step_info(*[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"physics kernel: attribute query failed: cudaError {err}")
    return dict(zip(("regs", "local_bytes", "shared_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def reset_counts():
    global launches
    launches = 0
    for v in range(4):
        launches_by_variant[v] = 0
        blocks_by_variant[v] = 0


def _check(t: torch.Tensor, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch_rows(table_rows, task_ids, state_rows, ctl, blocks: BlockTable,
                lib=None) -> torch.Tensor:
    """Run the kernel on packed rows, one launch over the block table:
    (SIM_ROWS, N) state and (4, N) control in, (SIM_ROWS, N) state out.
    `lib` is another build of the kernel library (kernel_sweep.py); by
    default the shipped one."""
    global launches
    if torch.is_grad_enabled() and (table_rows.requires_grad
                                    or state_rows.requires_grad
                                    or ctl.requires_grad):
        raise RuntimeError(
            "the physics kernel has no backward pass: to differentiate "
            "through the physics, step with physics='torch' (the plain "
            "PyTorch lane engine), or run the kernel under torch.no_grad()")
    dev = state_rows.device
    n = state_rows.shape[1]
    n_tasks = table_rows.shape[0]
    _check(table_rows, "scene table", torch.float32, (n_tasks, SC_ROWS), dev)
    _check(task_ids, "task_ids", torch.int32, (n,), dev)
    _check(state_rows, "state rows", torch.float32, (SIM_ROWS, n), dev)
    _check(ctl, "control rows", torch.float32, (4, n), dev)
    _check(blocks.rows, "block table", torch.int32,
           (blocks.host.shape[0], BLOCK_COLS), dev)
    if blocks.block != BLOCK or blocks.n != n or blocks.task_end > n_tasks:
        raise ValueError(f"block table of {blocks.n} envs in blocks of "
                         f"{blocks.block} over {blocks.task_end} tasks does not "
                         f"fit {n} envs in blocks of {BLOCK} over {n_tasks} tasks")
    lib = lib or _load()
    out = torch.empty_like(state_rows)
    err = lib.mw_step(
        blocks.rows.data_ptr(), blocks.host.shape[0],
        table_rows.data_ptr(), task_ids.data_ptr(), state_rows.data_ptr(),
        ctl.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"physics kernel launch failed: cudaError {err}")
    launches += 1
    for v, c in enumerate(blocks.blocks_by_variant):
        launches_by_variant[v] += c > 0
        blocks_by_variant[v] += c
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


def control_step(table: SceneTable, task_ids, sim: SimState, action,
                 blocks: BlockTable | None = None) -> SimState:
    """One control step of N envs. `task_ids` (N,) int32 index the table;
    `blocks` is the launch's `block_table` over them (None: every block
    runs all features; building that table reads `task_ids` on the host).
    CUDA tensors launch the kernel; CPU tensors run `plain_control_step`.
    The kernel has no backward: with grad mode on and an input that
    requires grad, the launch raises (`launch_rows`)."""
    if sim.hand.device.type != "cuda":
        return plain_control_step(table, task_ids, sim, action)
    if blocks is None:
        blocks = block_table(task_ids.cpu().numpy(),
                             np.ones((table.rows.shape[0], 3), bool),
                             device=task_ids.device)
    mocap, target, effort = _sim_and_ctl(table, task_ids, sim, action)
    ctl = torch.cat([target.T, effort[None]], dim=0).contiguous()
    out = launch_rows(table.rows, task_ids, pack_sim_rows(sim), ctl, blocks)
    return unpack_sim_rows(out, mocap)
