# Frozen copy of metaworld_tpu_torch/physics/maths.py at commit 3742bce; imports renamed.
"""Quaternion helpers (wxyz, like MuJoCo) on `(..., 4)` tensors.

Counterpart of `metaworld_tpu/physics/maths.py`, limited to what the port
reads.
"""

from __future__ import annotations

import torch


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    """Rotate vector v by quaternion q (wxyz)."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return quat_mul(quat_mul(q, qv), quat_conj(q))[..., 1:]


def axis_angle_quat(axis, angle):
    """Unit quaternion for a rotation of `angle` (...,) about `axis` (..., 3)."""
    half = angle / 2.0
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def quat_to_xyzw(q):
    return torch.cat([q[..., 1:], q[..., :1]], dim=-1)


def quat_to_mat(q):
    """(..., 4) wxyz -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def norm_fma(x):
    """Euclidean norm over the last axis of x (n, k), rounded as XLA rounds
    jnp.linalg.norm in float32: the squares are summed by a chain of fused
    multiply-adds from the first component to the last, then one sqrt.
    Each fused step runs in float64, where the product of two float32
    numbers is exact, and rounds to float32 once. The sqrt also runs in
    float64, whose one rounding to float32 is then the correctly rounded
    float32 sqrt (torch's float32 sqrt on the CPU is not)."""
    x64 = x.double()
    acc = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = torch.addcmul(acc.double(), x64[..., i], x64[..., i]).float()
    return torch.sqrt(acc.double()).float()
