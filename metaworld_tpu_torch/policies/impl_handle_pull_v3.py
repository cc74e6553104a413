"""Scripted policy for handle-pull-v3 (ref policies/sawyer_handle_pull_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("handle-pull-v3")
def handle_pull_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    handle = o["obj1_pos"] + const(obs, 0.0, -0.04, 0.0)
    # NB the reference returns the scalar handle z (broadcast) in the middle
    # branch (sawyer_handle_pull_v3_policy.py) — kept verbatim
    desired = select(
        (norm(hand[:, :2] - handle[:, :2]) > 0.02, handle),
        (torch.abs(hand[:, 2] - handle[:, 2]) > 0.02, handle[:, 2:].expand_as(handle)),
        default=handle + const(obs, 0.0, 0.0, 0.1),
    )
    return action(move(hand, desired, p=25.0), 1.0)
