"""Scripted policy for reach-v3 (ref policies/sawyer_reach_v3_policy.py)."""

from __future__ import annotations

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, move, parse_obs


@register_policy("reach-v3")
def reach_v3_policy(obs):
    o = parse_obs(obs)
    return action(move(o["hand_pos"], o["goal_pos"], p=5.0), 0.0)
