"""Scripted policy for handle-pull-side-v3 (ref policies/sawyer_handle_pull_side_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("handle-pull-side-v3")
def handle_pull_side_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    handle = o["obj1_pos"]
    handle_xy = norm(hand[:, :2] - handle[:, :2])
    handle_z = torch.abs(hand[:, 2] - handle[:, 2])
    desired = select(
        (handle_xy > 0.04, handle + const(obs, 0.0, 0.0, 0.1)),
        (handle_z > 0.03, handle),
        default=handle + const(obs, 0.0, 0.0, 1.0),
    )
    far = (handle_xy > 0.04) | (handle_z > 0.04)
    grab = torch.where(far, 0.0, 0.6)
    return action(move(hand, desired, p=25.0), grab)
