"""Scripted policy for assembly-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("assembly-v3")
def assembly_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    wrench = o["obj1_pos"] + const(obs, -0.02, 0.0, 0.0)
    peg = o["goal_pos"] + const(obs, 0.12, 0.0, 0.14)
    wrench_xy = norm(hand[:, :2] - wrench[:, :2])
    wrench_z = torch.abs(hand[:, 2] - wrench[:, 2])
    desired = select(
        (wrench_xy > 0.02, wrench + const(obs, 0.0, 0.0, 0.1)),
        (norm(hand[:, :2] - peg[:, :2]) <= 0.02, peg + const(obs, 0.0, 0.0, -0.2)),
        (wrench_z > 0.05, wrench + const(obs, 0.0, 0.0, 0.03)),
        (torch.abs(hand[:, 2] - peg[:, 2]) > 0.04, vec3(hand[:, 0], hand[:, 1], peg[:, 2])),
        default=peg,
    )
    far = (wrench_xy > 0.02) | (wrench_z > 0.12)
    grab = torch.where(far, 0.0, 0.6)
    return action(move(hand, desired, p=10.0), grab)
