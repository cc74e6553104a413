"""Multi-device scaling benchmark: env-steps/s against the number of shards.

Counterpart of `scripts/scaling_bench.py` over `parallel.ShardedEnvs`: a
size is a shard count, and the JAX script's `lax.scan` over the sharded
step is a loop of `ShardedEnvs.step` (zero actions), timed after one
warm-up pass. Shards go on distinct cards while there are enough of
them; past the visible card count (and always on the CPU) the devices
repeat the base device, which checks the sharded path's mechanics
(placement, per-shard streams, divisibility), not speedup:
`scaling_efficiency` means something only with one card per shard.

    python -m metaworld_tpu_torch.scaling_bench                 # 1..cards
    python -m metaworld_tpu_torch.scaling_bench --sizes 1,2     # on cuda:0
    python -m metaworld_tpu_torch.scaling_bench --device cpu --sizes 1,2 \\
        --batch 40 --steps 5

Prints one JSON line per size:
    {"devices": N, "envs": B, "steps_per_s": S, "per_device": S/N,
     "scaling_efficiency": ...}
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from metaworld_tpu_torch import benchmarks
from metaworld_tpu_torch.parallel import ShardedEnvs, make_env_mesh


def shard_devices(device, n: int) -> list:
    """n devices for n shards: the first n cards when `device` is CUDA and
    that many are visible, else `device` n times."""
    device = torch.device(device)
    if device.type == "cuda" and n <= torch.cuda.device_count():
        return make_env_mesh(n)
    return [device] * n


def _sync(devices):
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def measure(bench, n: int, batch: int, steps: int, device="cuda") -> dict:
    """One size: `steps` steps of ShardedEnvs over n shards, after one
    warm-up pass of as many steps."""
    # round the per-task count up so the total env batch divides the shards
    per_task = max(batch // max(len(bench.train_classes), 1), n)
    per_task = -(-per_task // n) * n
    envs = ShardedEnvs(bench, envs_per_task=per_task,
                       devices=shard_devices(device, n))
    states, _ = envs.reset(seed=0)
    acts = torch.zeros(envs.num_envs, 4, device=envs.devices[0])

    def roll(states):
        for _ in range(steps):
            states, _ = envs.step(states, acts)
        return states

    states = roll(states)
    _sync(envs.devices)
    t0 = time.perf_counter()
    roll(states)
    _sync(envs.devices)
    dt = time.perf_counter() - t0
    return {"devices": n, "envs": envs.num_envs,
            "steps_per_s": envs.num_envs * steps / dt}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4096,
                    help="total envs per task-group (divided over devices)")
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--bench", default="MT10")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated shard counts (default: 1, 2, 4, ... "
                         "up to the visible card count)")
    args = ap.parse_args(argv)

    if args.sizes:
        sizes = [int(s) for s in args.sizes.split(",")]
    else:
        n_dev = (torch.cuda.device_count()
                 if torch.device(args.device).type == "cuda" else 1)
        sizes = [s for s in (1, 2, 4, 8, 16, 32, 64) if s <= max(n_dev, 1)]
    bench = (getattr(benchmarks, args.bench)(seed=0)
             if args.bench.startswith(("MT", "ML"))
             else benchmarks.MT1(args.bench, seed=0))
    base = None
    rows = []
    for n in sizes:
        row = measure(bench, n, args.batch, args.steps, args.device)
        sps = row["steps_per_s"]
        if base is None:
            base = sps / n
        row.update(steps_per_s=round(sps), per_device=round(sps / n),
                   scaling_efficiency=round(sps / n / base, 3))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
