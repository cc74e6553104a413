"""Scripted policy for handle-press-v3 (ref policies/sawyer_handle_press_v3_policy.py)."""

from __future__ import annotations

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("handle-press-v3")
def handle_press_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    button = o["obj1_pos"] + const(obs, 0.0, -0.02, 0.0)
    desired = select(
        (norm(hand[:, :2] - button[:, :2]) > 0.02, button + const(obs, 0.0, 0.0, 0.2)),
        default=button + const(obs, 0.0, 0.0, -0.5),
    )
    return action(move(hand, desired, p=25.0), -1.0)
