"""Shared helpers for the task modules, batched over a task's slots."""

from __future__ import annotations

import torch

from metaworld_tpu_torch.envs.core import EvalOut, live_obj_quat
from metaworld_tpu_torch.physics import maths
from metaworld_tpu_torch.types import MAX_OBJ, N_EXTRAS

# Masked resampling rounds of `sample_until`. Goal-table rows already pass
# their task's test (the benchmark draws them through the same rejection
# loop), so on the engine's path no round ever replaces a row.
SAMPLE_ROUNDS = 8


def live_quat(spec, state):
    return live_obj_quat(spec, state)


def pad_obj_pos(*positions):
    """(n, MAX_OBJ, 3) from up to MAX_OBJ (n, 3) positions, zero-padded."""
    p0 = positions[0]
    out = torch.zeros(p0.shape[0], MAX_OBJ, 3, device=p0.device)
    for i, p in enumerate(positions):
        out[:, i] = p
    return out


def extras_vec(*values):
    """(n, N_EXTRAS) from up to N_EXTRAS (n,) reset-time scalars."""
    v0 = values[0]
    out = torch.zeros(v0.shape[0], N_EXTRAS, device=v0.device)
    for i, v in enumerate(values):
        out[:, i] = v
    return out


def sample_until(good_fn, rand_vec, gen, low, high):
    """Rejection resampling of the reset vectors (n, d), written as a fixed
    number of masked rounds: a row that fails `good_fn` is replaced by a
    fresh uniform draw in [low, high), and a row that passes is kept."""
    v = rand_vec
    for _ in range(SAMPLE_ROUNDS):
        bad = ~good_fn(v)
        u = torch.rand(v.shape, generator=gen, device=v.device)
        v = torch.where(bad[:, None], low + u * (high - low), v)
    return v


def vec3(x, y, z):
    """(n, 3) from three (n,) lanes or Python numbers (at least one lane)."""
    like = next(t for t in (x, y, z) if isinstance(t, torch.Tensor))
    return torch.stack([t if isinstance(t, torch.Tensor)
                        else torch.full_like(like, t) for t in (x, y, z)],
                       dim=-1)


def const_rows(like, c):
    """(n, 3) rows of a constant Python 3-tuple `c`, filled on the device
    of `like` (n, ...)."""
    lane = like.reshape(like.shape[0], -1)[:, 0]
    return torch.stack([torch.full_like(lane, float(v)) for v in c], dim=-1)


def rotate_const(q, v):
    """A constant 3-vector `v` (Python numbers) rotated by quaternions
    q (n, 4): maths.quat_rotate on a vector filled on q's device."""
    return maths.quat_rotate(q, const_rows(q, v))


def eval_out(reward, success, near_object=0.0, grasp_success=0.0,
             grasp_reward=0.0, in_place_reward=0.0, obj_to_target=0.0,
             unscaled_reward=None) -> EvalOut:
    def f(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float32)
        return torch.full_like(reward, float(x))

    return EvalOut(
        reward=f(reward),
        success=f(success),
        near_object=f(near_object),
        grasp_success=f(grasp_success),
        grasp_reward=f(grasp_reward),
        in_place_reward=f(in_place_reward),
        obj_to_target=f(obj_to_target),
        unscaled_reward=f(reward if unscaled_reward is None else unscaled_reward),
    )

