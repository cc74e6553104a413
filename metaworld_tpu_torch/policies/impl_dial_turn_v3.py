"""Scripted policy for dial-turn-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("dial-turn-v3")
def dial_turn_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    dial = o["obj1_pos"] + const(obs, 0.05, 0.02, 0.09)
    desired = select(
        (norm(hand[:, :2] - dial[:, :2]) > 0.02, vec3(dial[:, 0], dial[:, 1], 0.2)),
        (torch.abs(hand[:, 2] - dial[:, 2]) > 0.02, dial),
        default=dial + const(obs, -0.05, 0.005, 0.0),
    )
    return action(move(hand, desired, p=10.0), 1.0)
