"""Scripted policy for disassemble-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("disassemble-v3")
def disassemble_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    wrench = o["obj1_pos"] + const(obs, -0.02, 0.0, 0.01)
    wrench_xy = norm(hand[:, :2] - wrench[:, :2])
    wrench_z = torch.abs(hand[:, 2] - wrench[:, 2])
    desired = select(
        (wrench_xy > 0.02, wrench + const(obs, 0.0, 0.0, 0.1)),
        (wrench_z > 0.03, wrench),
        default=hand + const(obs, 0.0, 0.0, 0.1),
    )
    far = (wrench_xy > 0.02) | (wrench_z > 0.07)
    grab = torch.where(far, 0.0, 0.8)
    return action(move(hand, desired, p=10.0), grab)
