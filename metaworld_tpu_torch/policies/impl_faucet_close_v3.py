"""Scripted policy for faucet-close-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("faucet-close-v3")
def faucet_close_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    faucet = o["obj1_pos"] + const(obs, 0.04, 0.0, 0.03)
    desired = select(
        (norm(hand[:, :2] - faucet[:, :2]) > 0.04, faucet + const(obs, 0.0, 0.0, 0.1)),
        (torch.abs(hand[:, 2] - faucet[:, 2]) > 0.04, faucet),
        default=faucet + const(obs, -0.1, 0.05, 0.0),
    )
    return action(move(hand, desired, p=25.0), 1.0)
