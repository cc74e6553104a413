"""Scripted policy for sweep-v3 (ref policies/sawyer_sweep_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("sweep-v3")
def sweep_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    cube = o["obj1_pos"] + const(obs, 0.0, 0.0, 0.015)
    goal = o["goal_pos"]
    xy_err = norm(hand[:, :2] - cube[:, :2])
    short = hand[:, 0] < 0.2
    desired = select(
        (short & (xy_err > 0.04), cube + const(obs, 0.0, 0.0, 0.3)),
        (short & (torch.abs(hand[:, 2] - cube[:, 2]) > 0.04), cube),
        default=goal + const(obs, 0.0, 0.0, 0.1),
    )
    raw = o["obj1_pos"]
    far = (norm(hand[:, :2] - raw[:, :2]) > 0.04) | (torch.abs(hand[:, 2] - raw[:, 2]) > 0.15)
    grab = select(
        (far, -1.0),
        (raw[:, 0] < 0.4, 0.7),
        default=-1.0,
    )
    return action(move(hand, desired, p=25.0), grab)
