"""Scripted policy for coffee-push-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("coffee-push-v3")
def coffee_push_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    mug = o["obj1_pos"] + const(obs, 0.01, 0.0, 0.05)
    goal = o["goal_pos"]
    mug_xy = norm(hand[:, :2] - mug[:, :2])
    mug_z = torch.abs(hand[:, 2] - mug[:, 2])
    desired = select(
        (mug_xy > 0.06, mug + const(obs, 0.0, 0.0, 0.2)),
        (mug_z > 0.02, mug),
        default=vec3(goal[:, 0], goal[:, 1], 0.1),
    )
    far = (mug_xy > 0.06) | (mug_z > 0.1)
    grab = torch.where(far, -1.0, 0.5)
    return action(move(hand, desired, p=10.0), grab)
