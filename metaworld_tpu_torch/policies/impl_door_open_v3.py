"""Scripted policy for door-open-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("door-open-v3")
def door_open_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    door = o["obj1_pos"] + const(obs, -0.05, 0.0, 0.0)
    desired = select(
        (norm(hand[:, :2] - door[:, :2]) > 0.12, door + const(obs, 0.06, 0.02, 0.2)),
        (torch.abs(hand[:, 2] - door[:, 2]) > 0.04, door + const(obs, 0.06, 0.02, 0.0)),
        default=door,
    )
    return action(move(hand, desired, p=25.0), 1.0)
