"""Scripted policy for coffee-button-v3 (ref policies/sawyer_coffee_button_v3_policy.py)."""

from __future__ import annotations

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("coffee-button-v3")
def coffee_button_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    button = o["obj1_pos"] + const(obs, 0.0, 0.0, -0.07)
    xz = norm(hand[:, 0::2] - button[:, 0::2])
    desired = select(
        (xz > 0.02, vec3(button[:, 0], hand[:, 1], button[:, 2])),
        default=button + const(obs, 0.0, 0.2, 0.0),
    )
    return action(move(hand, desired, p=10.0), -1.0)
