"""Scripted policy for stick-push-v3 (ref policies/)."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.tasks.common import vec3
from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("stick-push-v3")
def stick_push_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    stick = o["obj1_pos"] + const(obs, 0.015, 0.0, 0.03)
    thermos = o["obj2_pos"]
    goal = o["goal_pos"] + const(obs, 0.0, 0.0, 0.132)
    stick_xy = norm(hand[:, :2] - stick[:, :2])
    stick_z = torch.abs(hand[:, 2] - stick[:, 2])
    approach = select(
        (stick_xy > 0.02, stick + const(obs, 0.0, 0.0, 0.1)),
        (stick_z > 0.02, stick),
        (torch.abs(stick[:, 1] - thermos[:, 1]) > 0.02,
         vec3(stick[:, 0], thermos[:, 1], stick[:, 2])),
        (torch.abs(stick[:, 2] - thermos[:, 2]) > 0.02,
         vec3(stick[:, 0], thermos[:, 1], thermos[:, 2])),
        default=thermos,
    )
    desired = select(
        (torch.abs(stick[:, 0] - thermos[:, 0]) > 0.04, approach),
        default=goal,
    )
    far = (stick_xy > 0.02) | (stick_z > 0.1)
    grab = torch.where(far, -1.0, 0.7)
    return action(move(hand, desired, p=10.0), grab)
