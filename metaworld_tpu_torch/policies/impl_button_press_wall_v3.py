"""Scripted policy for button-press-wall-v3 (ref policies/sawyer_button_press_wall_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, parse_obs, select


@register_policy("button-press-wall-v3")
def button_press_wall_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    button = o["obj1_pos"] + const(obs, 0.0, 0.0, 0.04)
    off_x = torch.abs(hand[:, 0] - button[:, 0]) > 0.02
    off_y = button[:, 1] - hand[:, 1] > 0.09
    off_z = torch.abs(hand[:, 2] - button[:, 2]) > 0.02
    desired = select(
        (off_x, vec3(button[:, 0], hand[:, 1], 0.3)),
        (off_y, vec3(button[:, 0], button[:, 1], 0.3)),
        (off_z, button + const(obs, 0.0, -0.05, 0.0)),
        default=button + const(obs, 0.0, -0.02, 0.0),
    )
    far = off_x | off_y | off_z
    grab = torch.where(far, 1.0, -1.0)
    return action(move(hand, desired, p=15.0), grab)
