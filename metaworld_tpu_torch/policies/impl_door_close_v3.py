"""Scripted policy for door-close-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, parse_obs, select


@register_policy("door-close-v3")
def door_close_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    door = o["obj1_pos"] + const(obs, 0.05, 0.12, 0.1)
    goal = o["goal_pos"]
    past = hand[:, 0] > door[:, 0]
    desired = select(
        (past & (hand[:, 2] < door[:, 2] + 0.2),
         vec3(hand[:, 0], hand[:, 1], door[:, 2] + 0.25)),
        (past, vec3(door[:, 0] - 0.02, door[:, 1], hand[:, 2])),
        (torch.abs(hand[:, 2] - door[:, 2]) > 0.04, door + const(obs, -0.02, 0.0, 0.0)),
        default=goal,
    )
    return action(move(hand, desired, p=25.0), 1.0)
