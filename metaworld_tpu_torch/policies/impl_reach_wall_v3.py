"""Scripted policy for reach-wall-v3 (ref policies/sawyer_reach_wall_v3_policy.py)."""

from __future__ import annotations

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, parse_obs, select


@register_policy("reach-wall-v3")
def reach_wall_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    goal = o["goal_pos"]
    near_wall = (
        (-0.1 <= hand[:, 0]) & (hand[:, 0] <= 0.3)
        & (0.60 <= hand[:, 1]) & (hand[:, 1] <= 0.80)
        & (hand[:, 2] < 0.25)
    )
    desired = select(
        (near_wall, goal + const(obs, 0.0, 0.0, 1.0)),
        default=goal,
    )
    return action(move(hand, desired, p=5.0), 0.0)
