"""Scripted policy for lever-pull-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("lever-pull-v3")
def lever_pull_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    lever = o["obj1_pos"] + const(obs, 0.0, -0.055, 0.0)
    desired = select(
        (norm(hand[:, :2] - lever[:, :2]) > 0.02, lever + const(obs, 0.0, 0.0, -0.1)),
        (torch.abs(hand[:, 2] - lever[:, 2]) > 0.02, lever),
        default=lever + const(obs, 0.0, 0.08, 0.02),
    )
    return action(move(hand, desired, p=25.0), 1.0)
