"""Scripted policy for window-open-v3 (ref policies/sawyer_window_open_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("window-open-v3")
def window_open_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    wndw = o["obj1_pos"] + const(obs, -0.03, -0.03, -0.08)
    desired = select(
        (norm(hand[:, :2] - wndw[:, :2]) > 0.04, wndw + const(obs, 0.0, 0.0, 0.3)),
        (torch.abs(hand[:, 2] - wndw[:, 2]) > 0.02, wndw),
        default=wndw + const(obs, 0.1, 0.0, 0.0),
    )
    return action(move(hand, desired, p=25.0), 1.0)
