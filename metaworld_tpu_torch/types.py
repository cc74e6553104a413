"""Core state containers of the PyTorch port.

Counterpart of `metaworld_tpu/types.py`: the same constants and the same
four containers, as plain dataclasses. A scene row built by
`envs.scene_builder` holds numpy arrays; everything the engine steps holds
`(N, ...)` tensors on one device. `tree_map` walks the (possibly nested)
containers field by field, the way `jax.tree.map` walks the JAX pytrees.

The JAX `EnvState.rng` key has no counterpart: the port draws its random
numbers from explicit `torch.Generator`s (see `vector.py`).
"""

from __future__ import annotations

import dataclasses

MAX_OBJ = 2
MAX_JOINT = 2
MAX_STATIC = 6
MAX_RAND = 12     # widest task rand_vec, padded
N_EXTRAS = 12     # task-specific reset-time reward margins

SIM_DT = 0.0025
FRAME_SKIP = 5
MAX_PATH_LENGTH = 500

HAND_SPACE_LOW = (-0.525, 0.348, -0.0525)
HAND_SPACE_HIGH = (0.525, 1.025, 0.7)
ACTION_SCALE = 1.0 / 100

GRIPPER_FULL_OPEN = 0.1

TABLE_Z = 0.0


class ObjType:
    NONE = 0
    CYLINDER = 1
    SPHERE = 2
    BOX = 3


class JointType:
    NONE = 0
    SLIDE = 1
    HINGE = 2


class _Tree:
    """Field-wise helpers shared by the containers."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map(self, fn, *others):
        return tree_map(fn, self, *others)


def tree_map(fn, tree, *others):
    """Apply `fn` to every leaf of a (nested) container, zipping `others`
    of the same structure alongside."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(tree)
        })
    return fn(tree, *others)


@dataclasses.dataclass
class SceneParams(_Tree):
    """Static per-task physics parameters (field meanings as in the JAX
    package's `types.SceneParams`)."""

    obj_exists: object
    obj_type: object
    obj_radius: object
    obj_half_x: object
    obj_oo_half_x: object
    obj_grasp_x_tol: object
    obj_half_h: object
    obj_mass: object
    obj_graspable: object
    obj_grasp_halfwidth: object
    obj_anchored: object
    obj_tool_off: object
    obj_droop: object
    obj_grasp_off: object
    obj_planar: object
    obj_lin_damping: object
    obj_friction: object
    obj_xy_limited: object
    obj_xy_lo: object
    obj_xy_hi: object
    obj_hook_grasp: object
    link_enable: object
    link_handle_off: object
    joint_exists: object
    joint_type: object
    joint_axis: object
    joint_anchor: object
    joint_arm: object
    joint_range: object
    joint_damping: object
    joint_stiffness: object
    joint_springref: object
    joint_inertia: object
    joint_bias: object
    joint_mass: object
    joint_com: object
    joint_handle_radius: object
    joint_face_radius: object
    joint_press_off: object
    joint_face_dir: object
    joint_hook_carry: object
    joint_hookable: object
    joint_panel_off: object
    joint_panel: object
    static_exists: object
    static_pos: object
    static_size: object
    static_rel: object
    static_blocks_hand: object
    hole_center: object
    hole_halfsize: object
    pit_depth: object
    table_z: object
    mocap_low: object
    mocap_high: object


@dataclasses.dataclass
class SimState(_Tree):
    """Dynamic physics state, `(N, ...)` per field."""

    mocap: object        # (N, 3)
    hand: object         # (N, 3)
    hand_vel: object     # (N, 3)
    gripper: object      # (N,)
    gripper_vel: object  # (N,)
    obj_pos: object      # (N, MAX_OBJ, 3)
    obj_quat: object     # (N, MAX_OBJ, 4) wxyz delta from the reset pose
    obj_vel: object      # (N, MAX_OBJ, 3)
    obj_angvel: object   # (N, MAX_OBJ, 3)
    joint_q: object      # (N, MAX_JOINT)
    joint_v: object      # (N, MAX_JOINT)
    attached: object     # (N, MAX_OBJ)
    attach_off: object   # (N, MAX_OBJ, 3)
    unanchored: object   # (N, MAX_OBJ)
    hooked: object       # (N, MAX_JOINT)
    hook_off: object     # (N, MAX_JOINT)
    hook_hoff: object    # (N, MAX_JOINT, 3)
    pad_force_l: object  # (N,)
    pad_force_r: object  # (N,)
    pad_l: object        # (N, 3)
    pad_r: object        # (N, 3)
    fixture_pos: object  # (N, 3)


@dataclasses.dataclass
class EnvState(_Tree):
    """Full per-env state: sim + episode bookkeeping + reset constants."""

    sim: SimState
    prev_obs: object       # (N, 18)
    target: object         # (N, 3)
    hand_init: object      # (N, 3)
    init_tcp: object       # (N, 3)
    init_left_pad: object  # (N, 3)
    init_right_pad: object  # (N, 3)
    obj_init_pos: object   # (N, MAX_OBJ, 3)
    extras: object         # (N, N_EXTRAS)
    rand_vec: object       # (N, MAX_RAND)
    path_length: object    # (N,) int32
    task_id: object        # (N,) int32
    goal_visible: object   # (N,) f32


@dataclasses.dataclass
class StepOut(_Tree):
    obs: object
    reward: object
    terminated: object
    truncated: object
    success: object
    near_object: object
    grasp_success: object
    grasp_reward: object
    in_place_reward: object
    obj_to_target: object
    unscaled_reward: object


def info_dict(out: StepOut) -> dict:
    """The reference's per-step info schema (ref sawyer_xyz_env.py:610-618)."""
    return {
        "success": out.success,
        "near_object": out.near_object,
        "grasp_success": out.grasp_success,
        "grasp_reward": out.grasp_reward,
        "in_place_reward": out.in_place_reward,
        "obj_to_target": out.obj_to_target,
        "unscaled_reward": out.unscaled_reward,
    }
