"""Scripted policy for basketball-v3 (ref policies/sawyer_basketball_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("basketball-v3")
def basketball_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    ball = o["obj1_pos"] + const(obs, 0.0, 0.0, 0.01)
    hoop = vec3(obs[:, -3], 0.875, 0.35)

    desired = select(
        (norm(hand[:, :2] - ball[:, :2]) > 0.04, ball + const(obs, 0.0, 0.0, 0.3)),
        (torch.abs(hand[:, 2] - ball[:, 2]) > 0.025, ball),
        (torch.abs(ball[:, 2] - hoop[:, 2]) > 0.025,
         const(obs, 1.0, 1.0, 0.0) * hand + const(obs, 0.0, 0.0, 1.0) * hoop[:, 2:]),
        default=hoop,
    )
    raw = o["obj1_pos"]
    far = (norm(hand[:, :2] - raw[:, :2]) > 0.04) | (torch.abs(hand[:, 2] - raw[:, 2]) > 0.15)
    grab = torch.where(far, -1.0, 0.6)
    return action(move(hand, desired, p=25.0), grab)
