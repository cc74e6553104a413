"""Multi-device batching: the env batch split over a list of devices.

Counterpart of `metaworld_tpu/parallel/mesh.py`. JAX describes the split as
a 1-D `Mesh` over the env axis and lets XLA place arrays through sharding
annotations. PyTorch has no such compiler, so the port's "mesh" is the list
of torch devices the batch is split over, in shard order, and placement is
explicit:

* `make_env_mesh(n_devices, devices)` gives that list (JAX: a `Mesh`).
* `shard_batch(tree, devices)` gives one tree per device: axis 0 of every
  leaf split into equal consecutive chunks, chunk i on device i; a leaf
  whose axis 0 does not divide is copied whole to every device (JAX: the
  same rule through `device_put` with `batch_sharding` / `replicated`).
* `batch_sharding(mesh)` and `replicated(mesh)` are XLA `NamedSharding`s
  (partition axis 0, replicate). Their port is `shard_batch`'s two cases:
  there is no sharding object, a tensor lives on one device.
* `constrain_batch(tree, mesh)` is an in-graph sharding constraint inside
  `jit`. The port compiles no program across devices: each shard's tensors
  are made on its own device (`sharded.ShardedEnvs` builds one engine per
  device), so there is nothing to constrain.
"""

from __future__ import annotations

import dataclasses

import torch


def make_env_mesh(n_devices: int | None = None, devices=None) -> list:
    """The devices an env batch is split over, in shard order. By default
    every visible CUDA device (the first `n_devices` of them); `devices`
    gives the list itself (for example `["cpu"] * 8`, or `["cuda:0"] * 2`
    for two shards on one card). A device may repeat. Raises when no list
    is given and no CUDA device is visible."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_env_mesh: no CUDA device is visible; pass devices=[...] "
                "(for example ['cpu'] * k) to split over other devices")
        devices = [torch.device("cuda", i) for i in range(count)]
        if n_devices is not None:
            devices = devices[:n_devices]
    return [torch.device(d) for d in devices]


def _split_leaf(x, devices):
    n = len(devices)
    x = torch.as_tensor(x)
    if x.dim() >= 1 and x.shape[0] > 0 and x.shape[0] % n == 0:
        return [c.to(d) for c, d in zip(x.chunk(n), devices)]
    return [x.to(d) for d in devices]


def shard_batch(tree, devices) -> list:
    """One copy of `tree` (a tensor, an array, a dict or a dataclass of
    them, nested) per device: leaves whose axis 0 divides by the number of
    devices are split along it, chunk i on device i; the others are copied
    whole to every device (per-group scalars, tables)."""
    n = len(devices)
    if isinstance(tree, dict):
        parts = {k: shard_batch(v, devices) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        parts = {f.name: shard_batch(getattr(tree, f.name), devices)
                 for f in dataclasses.fields(tree)}
        return [type(tree)(**{k: p[i] for k, p in parts.items()})
                for i in range(n)]
    return _split_leaf(tree, devices)
