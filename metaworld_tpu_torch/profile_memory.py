"""Memory profile: bytes per env slot, device memory, host RSS.

Counterpart of `scripts/profile_memory.py`. The reference budgets < 250 MB
per env process (ref tests/integration/test_memory_usage.py:40-49) because
every env is a full MuJoCo instance in its own OS process; here an env is
a few hundred floats in the batched state, and this script prints the
footprint so the contrast is auditable. Device memory comes from
`torch.cuda.memory_allocated` / `max_memory_allocated` (None on the CPU).

    python -m metaworld_tpu_torch.profile_memory --bench MT10 --envs-per-task 512
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from metaworld_tpu_torch import benchmarks, vector


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) dataclass or dict."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return 0


def host_rss() -> int | None:
    try:
        with open("/proc/self/status") as f:
            return int(f.read().split("VmRSS:")[1].split()[0]) * 1024
    except (OSError, IndexError, ValueError):
        return None


def profile(bench_name: str = "MT10", envs_per_task: int = 512,
            device="cuda") -> dict:
    """One reset and one step of zero actions on `bench_name` (a benchmark
    or a task name); the sizes of the state and the step's outputs."""
    bench = (getattr(benchmarks, bench_name)(seed=0)
             if bench_name.startswith(("MT", "ML"))
             else benchmarks.MT1(bench_name, seed=0))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    envs = vector.from_benchmark(bench, envs_per_task=envs_per_task, device=dev)
    state, _ = envs.reset(seed=0)
    state, out = envs.step(state, torch.zeros(envs.num_envs, 4, device=dev))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    state_b, out_b = tree_bytes(state), tree_bytes(out)
    return {
        "num_envs": envs.num_envs,
        "state_bytes": state_b,
        "step_out_bytes": out_b,
        "bytes_per_env": round((state_b + out_b) / envs.num_envs),
        "device_bytes_in_use": torch.cuda.memory_allocated(dev) if cuda else None,
        "device_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "host_rss_bytes": host_rss(),
        "ref_budget_bytes_per_env": 250 * 2**20,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", default="MT10")
    ap.add_argument("--envs-per-task", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(profile(args.bench, args.envs_per_task, args.device)))


if __name__ == "__main__":
    main()
