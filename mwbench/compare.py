"""The comparisons that decide `correct`: gaps between what the program's
timed path produced and what the plain reference computes from the same
inputs. Every number is a widest gap or a count; each has its limit in the
traffic file of its cell."""

from __future__ import annotations

import dataclasses

import torch

# outputs of the fused step compared as counters (exactly) and as shaped
# rewards; the rest of the float outputs and state leaves are state
COUNTERS = ("done", "terminated", "truncated", "episode_length",
            "pending_reset", "path_length", "task_id", "goal_idx")
REWARDS = ("reward", "episode_return", "near_object", "grasp_success",
           "grasp_reward", "in_place_reward", "obj_to_target", "unscaled_reward")


def as_tree(obj):
    """Nested dicts of tensors from nested dataclasses (field names kept)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: as_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: as_tree(v) for k, v in obj.items()}
    return obj


def leaves(tree, prefix=""):
    """[(dotted name, tensor)] of a nested dict or dataclass tree."""
    tree = as_tree(tree)
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(leaves(v, name + "."))
        else:
            out.append((name, v))
    return out


def unflatten(flat: dict, device) -> dict:
    """Nested dicts from {dotted name: tensor} (`leaves`), moved to `device`."""
    tree = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.to(device)
    return tree


class HostCopy:
    """Buffers on the host for the leaves of a tree, pinned where the tree
    lives on a CUDA device, so that `put` enqueues its copies on the stream
    without waiting: the values the tree holds at that point of the stream,
    whatever later steps do to its storage, and no device memory held."""

    def __init__(self, tree):
        self.flat = {n: torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
                     for n, t in leaves(tree)}

    @torch.no_grad()
    def put(self, tree) -> "HostCopy":
        for n, t in leaves(tree):
            self.flat[n].copy_(t, non_blocking=True)
        return self

    def tree(self, device) -> dict:
        return unflatten(self.flat, device)

    def part(self, key: str, device) -> dict:
        """{name below `key`: tensor} of the top-level entry `key`, its
        names kept whole (a parameter's name has dots of its own)."""
        cut = len(key) + 1
        return {n[cut:]: t.to(device) for n, t in self.flat.items()
                if n.startswith(key + ".")}


def _gaps(got, ref) -> torch.Tensor:
    """|got - ref| / max(1, |ref|) elementwise, in float64; an element that
    is non-finite on one side only counts as infinite."""
    got, ref = got.double(), ref.double()
    d = (got - ref).abs() / ref.abs().clamp(min=1.0)
    both = ~torch.isfinite(got) & ~torch.isfinite(ref) & (got == ref)
    return torch.where(both, 0.0, torch.nan_to_num(d, nan=float("inf")))


def mixed_gap(got, ref) -> float:
    """The widest of `_gaps`."""
    d = _gaps(got, ref)
    return float(d.max()) if d.numel() else 0.0


def _per_slot(got, ref) -> torch.Tensor:
    """(n,) widest of `_gaps` in each slot (the leading axis)."""
    d = _gaps(got, ref)
    return d.reshape(d.shape[0], -1).amax(-1)


def step_numbers(got_state, got_out, ref_state, ref_out, limits) -> tuple:
    """(numbers, slots rejected) of one fused step: the program's state and
    outputs against the reference's. A slot is rejected where one of its
    gaps is over its limit in `limits`, a counter differs or its success
    flips."""
    got = dict(leaves(got_state))
    got.update(got_out)
    ref = dict(leaves(ref_state))
    ref.update(ref_out)
    n = next(iter(ref.values())).shape[0]
    zero = torch.zeros(n, dtype=torch.float64, device=next(iter(ref.values())).device)
    state, reward, flips, counters = zero, zero, zero, zero
    for name, r in ref.items():
        key = name.split(".")[-1]
        g = got[name]
        if key in COUNTERS:
            counters = counters + (g != r).reshape(n, -1).any(-1)
        elif key == "success":
            flips = flips + ((g - r).abs() > 0.5).double()
        elif key in REWARDS:
            reward = torch.maximum(reward, _per_slot(g, r))
        else:
            state = torch.maximum(state, _per_slot(g, r))
    nums = {"state_gap": float(state.max()), "reward_gap": float(reward.max()),
            "success_flips": float(flips.sum()),
            "counter_mismatch": float((counters > 0).sum())}
    bad = ((state > limits["state_gap"]) | (reward > limits["reward_gap"])
           | (flips > 0) | (counters > 0))
    return nums, int(bad.sum())


def merge(a: dict, b: dict) -> dict:
    """Widest gaps and summed counts of two sets of numbers."""
    out = dict(a)
    for k, v in b.items():
        if k not in out:
            out[k] = v
        elif k.endswith("_gap"):
            out[k] = max(out[k], v)
        else:
            out[k] = out[k] + v
    return out


def leaf_norm_gap(got: dict, ref: dict, keep=None) -> float:
    """Worst leaf's |‖got‖ - ‖ref‖| over the larger of that leaf's ‖ref‖
    and the median leaf's ‖ref‖; `keep` names the leaves compared, and a
    leaf that `got` lacks has the norm 0."""
    names = [n for n in ref if keep is None or n in keep]
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = float(torch.tensor(sorted(rn.values())).median()) if rn else 0.0
    worst = 0.0
    for n in names:
        gn = float(got[n].double().norm()) if n in got else 0.0
        den = max(rn[n], med)
        gap = abs(gn - rn[n]) / den if den > 0 else (0.0 if gn == 0 else float("inf"))
        if gap != gap:
            gap = float("inf")
        worst = max(worst, gap)
    return worst
