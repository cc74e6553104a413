"""Scripted policy for button-press-topdown-v3 (ref policies/sawyer_button_press_topdown_v3_policy.py)."""

from __future__ import annotations

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("button-press-topdown-v3")
def button_press_topdown_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    button = o["obj1_pos"]
    desired = select(
        (norm(hand[:, :2] - button[:, :2]) > 0.04, button + const(obs, 0.0, 0.0, 0.1)),
        default=button,
    )
    return action(move(hand, desired, p=25.0), 1.0)
