"""Scripted policy for bin-picking-v3 (ref policies/sawyer_bin_picking_v3_policy.py)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("bin-picking-v3")
def bin_picking_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    cube = o["obj1_pos"] + const(obs, 0.0, 0.0, 0.03)
    # pretend the cube is centered in the bin along y so the fingers don't
    # catch the bin wall (ref comment)
    cube = vec3(cube[:, 0], torch.clamp(cube[:, 1], 0.675, 0.725), cube[:, 2])
    pos_bin = const(obs, 0.12, 0.7, 0.02)

    cube_xy = norm(hand[:, :2] - cube[:, :2])
    cube_z = torch.abs(hand[:, 2] - cube[:, 2])
    bin_xy = norm(hand[:, :2] - pos_bin[:, :2])
    desired = select(
        (cube_xy > 0.02, cube + const(obs, 0.0, 0.0, 0.15)),
        (cube_z > 0.01, cube),
        ((bin_xy > 0.02) & (hand[:, 2] < 0.15), hand + const(obs, 0.0, 0.0, 0.1)),
        (bin_xy > 0.02, const(obs, 0.12, 0.7, 0.18)),
        default=pos_bin,
    )
    far = (cube_xy > 0.02) | (cube_z > 0.02)
    grab = torch.where(far, -1.0, 0.6)
    return action(move(hand, desired, p=25.0), grab)
