"""Scripted policy for box-close-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("box-close-v3")
def box_close_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    lid = o["obj1_pos"] + const(obs, 0.0, 0.0, 0.02)
    box = vec3(o["goal_pos"][:, 0], o["goal_pos"][:, 1], 0.15)
    lid_xy = norm(hand[:, :2] - lid[:, :2])
    lid_z = torch.abs(hand[:, 2] - lid[:, 2])
    desired = select(
        (lid_xy > 0.01, vec3(lid[:, 0], lid[:, 1], 0.2)),
        (lid_z > 0.05, lid),
        (torch.abs(hand[:, 2] - box[:, 2]) > 0.04, vec3(hand[:, 0], hand[:, 1], box[:, 2])),
        default=box,
    )
    far = (lid_xy > 0.01) | (lid_z > 0.13)
    grab = torch.where(far, 0.5, 1.0)
    return action(move(hand, desired, p=25.0), grab)
