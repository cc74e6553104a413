"""Scripted policy for pick-place-v3 (ref policies/sawyer_pick_place_v3_policy.py).

State machine (:39-64): hover over puck -> descend -> wait for grip ->
carry to goal; grab when within 0.07 of the puck."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.policies import register_policy
from metaworld_tpu_torch.policies.base import action, const, move, norm, parse_obs, select


@register_policy("pick-place-v3")
def pick_place_v3_policy(obs):
    o = parse_obs(obs)
    hand = o["hand_pos"]
    puck = o["obj1_pos"] + const(obs, -0.005, 0.0, 0.0)
    goal = o["goal_pos"]
    grip_sep = o["gripper"]

    xy_err = norm(hand[:, :2] - puck[:, :2])
    desired = select(
        (xy_err > 0.02, puck + const(obs, 0.0, 0.0, 0.1)),
        ((torch.abs(hand[:, 2] - puck[:, 2]) > 0.05) & (puck[:, 2] < 0.04),
         puck + const(obs, 0.0, 0.0, 0.03)),
        (grip_sep > 0.73, hand),
        default=goal,
    )
    grab = torch.where(norm(hand - o["obj1_pos"]) < 0.07, 1.0, 0.0)
    return action(move(hand, desired, p=10.0), grab)
