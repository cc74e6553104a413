"""Zero-communication multi-device env engine: one fused engine per device.

Counterpart of `metaworld_tpu/parallel/sharded.py`. The JAX engine runs the
same fused step program on every device's local env batch under
`shard_map`, so the per-task slices of the fused step stay device-local and
stepping needs no collective. Here every shard is a `FusedBatchedEnvs` of
its own, built on its device from the same benchmark with
`envs_per_task // n_shards` slots per task (a miniature of the global
task-group layout), and every shard steps on a CUDA stream of its own:

* a shard's stream first waits on the caller's current stream of its
  device (the actions and states the caller made), then runs the shard's
  step, its one kernel launch included, then records an event; the
  caller's stream waits on every shard's event. Nothing in a step waits on
  the host, and no tensor moves between shards.
* a shard's tensors, generator, scene table and block table live on its
  device, and the kernel writes a buffer of its own per launch, so two
  shards may share a device (`devices=["cuda:0"] * 2` on one card).
* the learner's all-gather stays outside the step, as in the JAX engine:
  `gather` concatenates what a learner reads onto one device.

Seeds: the JAX engine gives shard i `jax.random.split(key, n)[i]`. Here
shard i's generator is seeded with `shard_seed(seed, i, n)`, the first
word of `numpy.random.SeedSequence(seed).spawn(n)[i]`: independent streams
from one seed, made the same way at construction (from the engine's `seed`
keyword, 0 by default) and at `reset(seed=...)`.
"""

from __future__ import annotations

import numpy as np
import torch

from metaworld_tpu_torch.parallel.mesh import make_env_mesh


def shard_seed(seed: int, i: int, n: int) -> int:
    """The generator seed of shard i of n from one seed."""
    return int(np.random.SeedSequence(seed).spawn(n)[i].generate_state(1)[0])


class ShardedEnvs:
    """An env batch split over devices: `envs_per_task` slots per task,
    evenly divided over the devices; each device steps its local slice
    independently. `devices` is the port's mesh (`make_env_mesh()`, every
    visible CUDA device, by default); `kwargs` go to
    `vector.from_benchmark` for every shard.

    States and outputs are per shard: `reset` returns (states, obs) and
    `step` returns (states, outs), lists with one entry per shard in device
    order, shard i holding global slots [i * m, (i + 1) * m) of m =
    `num_envs // n_shards`."""

    def __init__(self, bench, envs_per_task: int, devices=None,
                 split: str = "train", **kwargs):
        from metaworld_tpu_torch import vector

        self.devices = make_env_mesh(devices=devices)
        n = len(self.devices)
        assert envs_per_task % n == 0, (
            f"envs_per_task={envs_per_task} must divide over the "
            f"{n}-device mesh")
        seed = kwargs.pop("seed", 0)
        self.shards = [
            vector.from_benchmark(bench, split=split,
                                  envs_per_task=envs_per_task // n, device=d,
                                  seed=shard_seed(seed, i, n), **kwargs)
            for i, d in enumerate(self.devices)]
        self.local = self.shards[0]
        self.n_shards = n
        self.num_envs = self.local.num_envs * n
        self.obs_dim = self.local.obs_dim
        self.task_names = self.local.task_names
        self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                         else None for d in self.devices]
        self._events = [torch.cuda.Event() if s is not None else None
                        for s in self._streams]

    def _on_shards(self, fn, args):
        """[fn(shard, *args[i]) for every shard], each on its own stream,
        ordered after the caller's stream and before its later work."""
        results = []
        for eng, s, ev, a in zip(self.shards, self._streams, self._events,
                                 args):
            if s is None:
                results.append(fn(eng, *a))
                continue
            s.wait_stream(torch.cuda.current_stream(s.device))
            with torch.cuda.stream(s):
                results.append(fn(eng, *a))
            ev.record(s)
        for s, ev in zip(self._streams, self._events):
            if s is not None:
                torch.cuda.current_stream(s.device).wait_event(ev)
        return results

    def reset(self, seed: int | None = None):
        """Fresh reset of every shard; `seed` reseeds shard i's generator
        with `shard_seed(seed, i, n_shards)`. Returns (states, obs)."""
        n = self.n_shards

        def one(eng, i):
            return eng.reset(seed=None if seed is None
                             else shard_seed(seed, i, n))

        res = self._on_shards(one, [(i,) for i in range(n)])
        return [r[0] for r in res], [r[1] for r in res]

    def _split_actions(self, actions) -> list:
        """Per-shard actions from an (num_envs, 4) tensor (views, moved to
        each shard's device) or a list of per-shard tensors."""
        if isinstance(actions, torch.Tensor):
            if actions.shape[0] != self.num_envs:
                raise ValueError(f"actions for {actions.shape[0]} envs, expected "
                                 f"{self.num_envs}")
            actions = actions.split(self.local.num_envs)
        if len(actions) != self.n_shards:
            raise ValueError(f"{len(actions)} action tensors for "
                             f"{self.n_shards} shards")
        return [a.to(d, non_blocking=True)
                for a, d in zip(actions, self.devices)]

    def step(self, states, actions):
        """One step of every shard. `actions` is an (num_envs, 4) tensor or
        a list of per-shard (num_envs // n_shards, 4) tensors. Returns
        (states, outs), per shard."""
        acts = self._split_actions(actions)
        res = self._on_shards(lambda eng, st, a: eng.step(st, a),
                              list(zip(states, acts)))
        return [r[0] for r in res], [r[1] for r in res]

    def gather(self, outs, keys=("obs", "reward", "done")):
        """The per-shard outputs `keys` concatenated in global slot order on
        the first shard's device, for a learner."""
        device = self.devices[0]
        return {k: torch.cat([o[k].to(device) for o in outs]) for k in keys}
