"""State converter between the JAX package's trees and the port's containers.

The JAX side hands its trees over as nested dicts of numpy arrays (`as_dict`
makes one from any dataclass tree, the JAX package's flax structs
included, without importing JAX); the `*_from_dict` functions build the
port's containers from such dicts on a device, and `as_dict` turns the
port's containers back into dicts. Fields the port does not keep are
dropped on the way in: `EnvState.rng` and the fused state's `key` (the
port draws from `torch.Generator`s instead). The scripted experts
(`policies`) have no parameters, so nothing is carried for them.

The wrapper states (`wrappers.RunningStat`, the reward and observation
norm states and the RNN meta-RL state) carry over field for field, so a
port `EnvPipeline` can continue a JAX pipeline's run
(`pipeline_state_from_dicts`). A JAX `ShardedEnvs` state splits into the
port's per-shard states (`sharded_from_dict`). `pi_from_flax` carries the
weights of the flax policy of scripts/train_apg.py into `train_apg.Pi`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from metaworld_tpu_torch import wrappers
from metaworld_tpu_torch.types import EnvState, SceneParams, SimState

_DROP = ("rng", "key")


def as_dict(tree) -> dict:
    """Nested dict of numpy arrays from a dataclass tree (either package)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: as_dict(getattr(tree, f.name))
                for f in dataclasses.fields(tree) if f.name not in _DROP}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dt = np.bool_
    elif a.dtype.kind in "iu":
        dt = np.int32
    else:
        dt = np.float32
    return torch.from_numpy(np.array(a, dtype=dt)).to(device)


def _build(cls, d: dict, device, nested=None):
    kw = {}
    for f in dataclasses.fields(cls):
        if nested and f.name in nested:
            kw[f.name] = _build(nested[f.name], d[f.name], device, nested)
        else:
            kw[f.name] = _tensor(d[f.name], device)
    return cls(**kw)


def scene_from_dict(d: dict) -> SceneParams:
    """Scene row as the port builds it: numpy, dtypes unchanged."""
    return SceneParams(**{f.name: np.asarray(d[f.name])
                          for f in dataclasses.fields(SceneParams)})


def sim_from_dict(d: dict, device="cuda") -> SimState:
    return _build(SimState, d, device)


def env_from_dict(d: dict, device="cuda") -> EnvState:
    return _build(EnvState, d, device, nested={"sim": SimState})


def _batch1(d):
    return ({k: _batch1(v) for k, v in d.items()} if isinstance(d, dict)
            else np.asarray(d)[None])


def env_from_single_dict(d: dict, device="cuda") -> EnvState:
    """A 1-slot EnvState from one env's unbatched state (the JAX package's
    per-env `EnvState`, as `as_dict` gives it)."""
    return env_from_dict(_batch1(d), device)


def fused_from_dict(d: dict, device="cuda"):
    """The fused engine's state (see vector.FusedState)."""
    from metaworld_tpu_torch.vector import FusedState

    return _build(FusedState, d, device,
                  nested={"env": EnvState, "sim": SimState})


def sharded_from_dict(d: dict, devices) -> list:
    """The per-shard states of `parallel.ShardedEnvs` on `devices` from a
    JAX `ShardedEnvs` state (one global fused state, sharded on its env
    axis, as `as_dict` gathers it): `fused_from_dict`'s state split along
    the env axis, chunk i on devices[i] (`parallel.mesh.shard_batch`)."""
    from metaworld_tpu_torch.parallel.mesh import shard_batch

    return shard_batch(fused_from_dict(d, "cpu"), devices)


def running_stat_from_dict(d: dict, device="cuda") -> wrappers.RunningStat:
    return _build(wrappers.RunningStat, d, device)


def reward_norm_from_dict(d: dict, device="cuda"):
    """A discounted (`returns`, `stat`) or exponential (`mean`, `var`,
    `initialized`) reward-norm state, told apart by its fields."""
    if "stat" in d:
        return _build(wrappers.DiscountedRewardNormState, d, device,
                      nested={"stat": wrappers.RunningStat})
    return _build(wrappers.ExponentialRewardNormState, d, device)


def obs_norm_from_dict(d: dict, device="cuda") -> wrappers.ObservationNormState:
    return _build(wrappers.ObservationNormState, d, device,
                  nested={"stat": wrappers.RunningStat})


def rnn_state_from_dict(d: dict, device="cuda") -> wrappers.RNNMetaRLState:
    return _build(wrappers.RNNMetaRLState, d, device)


def pipeline_state_from_dicts(vstate, rnorm, onorm, rnn, device="cuda"):
    """The state tuple of `wrappers.EnvPipeline` from the four parts of a
    JAX pipeline's state as dicts (`as_dict`); a part that is None (its
    wrapper is off) stays None."""
    def opt(fn, d):
        return None if d is None else fn(d, device)

    return (fused_from_dict(vstate, device), opt(reward_norm_from_dict, rnorm),
            opt(obs_norm_from_dict, onorm), opt(rnn_state_from_dict, rnn))


def pi_from_flax(params: dict, device="cuda"):
    """`train_apg.Pi` with the weights of a flax `Pi` (its params tree as
    nested dicts of numpy arrays: Dense_0..Dense_2, each a (in, out)
    `kernel` and a (out,) `bias`)."""
    from metaworld_tpu_torch.train_apg import Pi

    p = params.get("params", params)
    dense = [p[f"Dense_{i}"] for i in range(3)]
    k0 = np.asarray(dense[0]["kernel"])
    pi = Pi(k0.shape[0], k0.shape[1])
    with torch.no_grad():
        for layer, d in zip(pi.layers, dense):
            layer.weight.copy_(torch.from_numpy(np.array(d["kernel"], np.float32).T))
            layer.bias.copy_(torch.from_numpy(np.array(d["bias"], np.float32)))
    return pi.to(device)
