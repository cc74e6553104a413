"""Scripted policy for coffee-pull-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("coffee-pull-v3")
def coffee_pull_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    mug = o["obj1_pos"] + const(obs, -0.005, 0.0, 0.05)
    desired = select(
        (norm(hand[:, :2] - mug[:, :2]) > 0.06, mug + const(obs, 0.0, 0.0, 0.15)),
        (torch.abs(hand[:, 2] - mug[:, 2]) > 0.02, mug),
        default=o["goal_pos"],
    )
    mug2 = o["obj1_pos"] + const(obs, 0.01, 0.0, 0.05)
    far = (norm(hand[:, :2] - mug2[:, :2]) > 0.06) | (torch.abs(hand[:, 2] - mug2[:, 2]) > 0.1)
    grab = torch.where(far, -1.0, 0.7)
    return action(move(hand, desired, p=10.0), grab)
