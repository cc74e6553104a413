"""Scripted policy for peg-unplug-side-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("peg-unplug-side-v3")
def peg_unplug_side_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    peg = o["obj1_pos"] + const(obs, -0.02, 0.0, 0.035)
    peg_xy = norm(hand[:, :2] - peg[:, :2])
    desired = select(
        (peg_xy > 0.04, peg + const(obs, 0.0, 0.0, 0.2)),
        (torch.abs(hand[:, 2] - 0.15) > 0.02, vec3(peg[:, 0], peg[:, 1], 0.15)),
        default=hand + const(obs, 0.01, 0.0, 0.0),
    )
    far = (peg_xy > 0.04) | (torch.abs(hand[:, 2] - peg[:, 2]) > 0.15)
    grab = torch.where(far, -1.0, 0.1)
    return action(move(hand, desired, p=25.0), grab)
