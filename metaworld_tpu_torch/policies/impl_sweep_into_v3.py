"""Scripted policy for sweep-into-v3 (ref policies/sawyer_sweep_into_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("sweep-into-v3")
def sweep_into_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    cube = o["obj1_pos"] + const(obs, -0.005, 0.0, 0.01)
    xy_err = norm(hand[:, :2] - cube[:, :2])
    desired = select(
        (xy_err > 0.04, cube + const(obs, 0.0, 0.0, 0.3)),
        (torch.abs(hand[:, 2] - cube[:, 2]) > 0.04, cube),
        default=o["goal_pos"],
    )
    raw = o["obj1_pos"]
    far = (norm(hand[:, :2] - raw[:, :2]) > 0.04) | (torch.abs(hand[:, 2] - raw[:, 2]) > 0.15)
    grab = torch.where(far, -1.0, 0.7)
    return action(move(hand, desired, p=25.0), grab)
