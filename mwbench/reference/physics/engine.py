# Frozen copy of metaworld_tpu_torch/physics/engine.py at commit 3742bce; imports renamed.
"""Engine constants and the small kinematic helpers the env layer reads.

Counterpart of the parts of `metaworld_tpu/physics/engine.py` that the
lane engine and the MT10 tasks use: the calibrated constants, the arm
reach-envelope table, pad/hand kinematics, fixture handle positions and
the settled post-reset hand. The per-env engine body itself is not ported:
the lane engine (`engine_lanes.py`) and its CUDA kernel are the port's one
physics implementation.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mwbench.reference.physics import maths
from mwbench.reference.types import GRIPPER_FULL_OPEN, JointType

TCP_OFFSET = (0.0044, 0.0015, -0.0498)
HAND_W = 40.0
HAND_ZETA = 1.0
HAND_VMAX = 1.2
HAND_BODY_OFFSET = (0.0, 0.0, 0.045)
PAD_Z_OFFSET = 0.045
PAD_GAP_INSET = 0.006

_REACH = np.load(
    os.path.join(os.path.dirname(__file__), "..", "data", "reach_envelope.npz")
)
REACH_LO = _REACH["lo"].astype(np.float32)
REACH_HI = _REACH["hi"].astype(np.float32)
REACH_N = _REACH["n"].astype(np.int32)
REACH_DELTA = _REACH["delta"].astype(np.float32)

_F_KP = 400.0
_F_DAMP = 1000.0
_F_MASS = 100.0
_R_RANGE = (0.0, 0.04)
_L_RANGE = (-0.03, 0.0)

_HAND_TIP_R = 0.005
_HAND_KNUCKLE_R = 0.03
_PAD_TIP_BEVEL = 0.008
_WELD_K = 600.0
_HOOK_SLIP = 0.13
_K_SLIDE_LIM = 400.0
_D_SLIDE_LIM = 30.0
_GRASP_XZ_TOL = 0.035
_GRASP_Z_SPAN = 0.09
_GRAVITY = 9.81
_MU_HAND = 1.0
_MU_TABLE = 1.5
_SQUEEZE_CREEP = 0.055


def _vec3(x, c):
    """x (..., 3) plus a python 3-tuple, column by column (no host->device
    copy: each constant enters as a kernel scalar)."""
    return torch.stack([x[..., k] + c[k] for k in range(3)], dim=-1)


def pad_kinematics(hand, gripper):
    """World positions of the left/right pad box centers (engine.py:164-176)."""
    gap = gripper * GRIPPER_FULL_OPEN - PAD_GAP_INSET
    half = gap / 2.0
    up = hand[..., 2] + PAD_Z_OFFSET
    left = torch.stack([hand[..., 0] + 0.0 * half, hand[..., 1] + half,
                        up + 0.0 * half], dim=-1)
    right = torch.stack([hand[..., 0] - 0.0 * half, hand[..., 1] - half,
                         up - 0.0 * half], dim=-1)
    return left, right


def pad_positions(sim):
    return sim.pad_l, sim.pad_r


def obs_hand_pos(sim):
    return _vec3(sim.hand, HAND_BODY_OFFSET)


def aperture_obs(sim):
    return torch.clamp(sim.gripper, 0.0, 1.0)


def fixture_handle_pos(scene, fixture_pos, joint_q):
    """(N, MAX_JOINT, 3) handle positions (engine.py:1965-1974). `scene`
    fields are (N, MAX_JOINT, ...) or broadcastable rows."""
    anchor = fixture_pos[..., None, :] + scene.joint_anchor
    slide = anchor + scene.joint_axis * joint_q[..., :, None]
    quat = maths.axis_angle_quat(scene.joint_axis, joint_q)
    arm = maths.quat_rotate(quat, scene.joint_arm)
    hinge = anchor + arm
    is_hinge = (scene.joint_type == JointType.HINGE)[..., None]
    return torch.where(is_hinge, hinge, slide)


def settled_hand_state(scene, hand_init):
    """Mocap and tcp after the reference's reset servo (engine.py:2006-2012)."""
    mocap = torch.minimum(torch.maximum(hand_init, scene.mocap_low),
                          scene.mocap_high)
    return mocap, _vec3(mocap, TCP_OFFSET)
