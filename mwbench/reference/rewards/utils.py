# Frozen copy of metaworld_tpu_torch/rewards/utils.py at commit 3742bce; imports renamed.
"""Reward-shaping primitives on batched tensors.

Counterpart of `metaworld_tpu/rewards/utils.py`: the same branchless
formulas (every data-dependent branch is a `torch.where`), with bounds and
margins that may be per-env tensors. Python-number margins are filled on
the input's device, so no host-to-device copy happens inside a step.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

_DEFAULT_VALUE_AT_MARGIN = 0.1


def _gaussian(x, value_at_1):
    scale = math.sqrt(-2.0 * math.log(value_at_1))
    return torch.exp(-0.5 * torch.square(x * scale))


def _hyperbolic(x, value_at_1):
    scale = math.acosh(1.0 / value_at_1)
    return 1.0 / torch.cosh(x * scale)


def _long_tail(x, value_at_1):
    scale = math.sqrt(1.0 / value_at_1 - 1.0)
    return 1.0 / (torch.square(x * scale) + 1.0)


def _reciprocal(x, value_at_1):
    scale = 1.0 / value_at_1 - 1.0
    return 1.0 / (torch.abs(x) * scale + 1.0)


def _cosine(x, value_at_1):
    scale = math.acos(2.0 * value_at_1 - 1.0) / math.pi
    scaled = x * scale
    return torch.where(torch.abs(scaled) < 1.0,
                       (1.0 + torch.cos(math.pi * scaled)) / 2.0, 0.0)


def _linear(x, value_at_1):
    scale = 1.0 - value_at_1
    scaled = x * scale
    return torch.where(torch.abs(scaled) < 1.0, 1.0 - scaled, 0.0)


def _quadratic(x, value_at_1):
    scale = math.sqrt(1.0 - value_at_1)
    scaled = x * scale
    return torch.where(torch.abs(scaled) < 1.0, 1.0 - torch.square(scaled), 0.0)


def _tanh_squared(x, value_at_1):
    scale = math.atanh(math.sqrt(1.0 - value_at_1))
    return 1.0 - torch.square(torch.tanh(x * scale))


SIGMOIDS: dict[str, Callable] = {
    "gaussian": _gaussian,
    "hyperbolic": _hyperbolic,
    "long_tail": _long_tail,
    "reciprocal": _reciprocal,
    "cosine": _cosine,
    "linear": _linear,
    "quadratic": _quadratic,
    "tanh_squared": _tanh_squared,
}


def sigmoid(x, value_at_1: float, kind: str):
    """Maps x to (0, 1], 1 at x == 0 and `value_at_1` at |x| == 1."""
    if kind in ("cosine", "linear", "quadratic"):
        if not 0 <= value_at_1 < 1:
            raise ValueError(f"`value_at_1` must be in [0, 1), got {value_at_1}.")
    else:
        if not 0 < value_at_1 < 1:
            raise ValueError(f"`value_at_1` must be in (0, 1), got {value_at_1}.")
    try:
        fn = SIGMOIDS[kind]
    except KeyError:
        raise ValueError(f"Unknown sigmoid type {kind!r}.") from None
    return fn(x, value_at_1)


_apply_sigmoid = sigmoid


def tolerance(x, bounds=(0.0, 0.0), margin=0.0, sigmoid: str = "gaussian",
              value_at_margin: float = _DEFAULT_VALUE_AT_MARGIN):
    """1.0 inside `bounds`, decaying sigmoidally outside over `margin`;
    margin == 0 degrades to the hard indicator."""
    lower, upper = bounds
    in_bounds = (lower <= x) & (x <= upper)
    if not isinstance(margin, torch.Tensor):
        margin = torch.full_like(x, float(margin))
    safe_margin = torch.where(margin == 0.0, 1.0, margin)
    d = torch.where(x < lower, lower - x, x - upper) / safe_margin
    soft = _apply_sigmoid(d, value_at_margin, sigmoid)
    return torch.where(
        margin == 0.0,
        torch.where(in_bounds, 1.0, 0.0),
        torch.where(in_bounds, 1.0, soft),
    )


def rect_prism_tolerance(curr, zero, one):
    """Scaled reward if `curr` (N, 3) lies in the axis-aligned prism
    spanned by zero..one; 1.0 outside."""
    lo = torch.minimum(zero, one)
    hi = torch.maximum(zero, one)
    in_prism = ((lo <= curr) & (curr <= hi)).all(dim=-1)
    scale = (curr - zero) / (one - zero)
    return torch.where(in_prism, scale[..., 0] * scale[..., 1] * scale[..., 2],
                       1.0)


def hamacher_product(a, b):
    """Hamacher t-norm a*b / (a + b - a*b), 0 where the denominator is 0."""
    denom = a + b - a * b
    return torch.where(denom > 0.0,
                       (a * b) / torch.where(denom > 0.0, denom, 1.0), 0.0)
