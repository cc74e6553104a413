"""Scripted policy for drawer-open-v3 (ref policies/sawyer_drawer_open_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("drawer-open-v3")
def drawer_open_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    drwr = o["obj1_pos"] + const(obs, 0.0, 0.0, -0.02)
    near_xy = norm(hand[:, :2] - drwr[:, :2])
    delta = select(
        (near_xy > 0.06, move(hand, drwr + const(obs, 0.0, 0.0, 0.3), p=4.0)),
        (torch.abs(hand[:, 2] - drwr[:, 2]) > 0.04, move(hand, drwr, p=4.0)),
        default=move(hand, drwr + const(obs, 0.0, -0.06, 0.0), p=50.0),
    )
    return action(delta, -1.0)
