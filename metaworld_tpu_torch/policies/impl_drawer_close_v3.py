"""Scripted policy for drawer-close-v3 (ref policies/sawyer_drawer_close_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, parse_obs, select


@register_policy("drawer-close-v3")
def drawer_close_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    drwr = o["obj1_pos"] + const(obs, 0.0, 0.0, -0.02)
    past = hand[:, 1] > drwr[:, 1]
    desired = select(
        (past & (hand[:, 2] < drwr[:, 2] + 0.23),
         vec3(hand[:, 0], hand[:, 1], drwr[:, 2] + 0.5)),
        (past, drwr + const(obs, 0.0, -0.075, 0.23)),
        (torch.abs(hand[:, 2] - drwr[:, 2]) > 0.04, drwr + const(obs, 0.0, -0.075, 0.0)),
        default=drwr,
    )
    return action(move(hand, desired, p=25.0), 1.0)
