"""Scripted policy for button-press-v3 (ref policies/sawyer_button_press_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, parse_obs, select


@register_policy("button-press-v3")
def button_press_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    button = o["obj1_pos"] + const(obs, 0.0, 0.0, -0.07)
    aligned = ((torch.abs(hand[:, 0] - button[:, 0]) <= 0.02)
               & (torch.abs(hand[:, 2] - button[:, 2]) <= 0.02))
    desired = select(
        (~aligned, vec3(button[:, 0], hand[:, 1] - 0.1, button[:, 2])),
        default=button + const(obs, 0.0, 0.02, 0.0),
    )
    return action(move(hand, desired, p=25.0), 0.0)
