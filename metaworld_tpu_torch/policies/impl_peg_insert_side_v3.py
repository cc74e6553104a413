"""Scripted policy for peg-insert-side-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("peg-insert-side-v3")
def peg_insert_side_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    peg = o["obj1_pos"]
    hole = vec3(-0.35, o["goal_pos"][:, 1], 0.16)
    peg_xy = norm(hand[:, :2] - peg[:, :2])
    peg_z = torch.abs(hand[:, 2] - peg[:, 2])
    desired = select(
        (peg_xy > 0.04, peg + const(obs, 0.0, 0.0, 0.3)),
        (peg_z > 0.025, peg),
        (norm(peg[:, 1:] - hole[:, 1:]) > 0.03, hole + const(obs, 0.4, 0.0, 0.0)),
        default=hole,
    )
    far = (peg_xy > 0.04) | (peg_z > 0.15)
    grab = torch.where(far, -1.0, 0.6)
    return action(move(hand, desired, p=25.0), grab)
