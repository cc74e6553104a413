"""The program under test, built from a configuration file: the fused
multi-task engine of metaworld_tpu_torch (`vector.FusedBatchedEnvs`) laid
out as `bench.build_envs` lays out a task set. Every seed the benchmark
hands out is derived here from `--seed`."""

from __future__ import annotations

import torch


def goal_seed(seed: int) -> int:
    """The seed of the task set's goal tables (numpy takes 32 bits)."""
    return seed % 2**32


def stream(seed: int, k: int) -> int:
    """The seed of the benchmark's k-th random stream."""
    return (seed % 2**59) * 16 + k


def generator(device, seed: int, k: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, k))
    return g


def task_counts(n_envs: int, n_tasks: int) -> list[int]:
    base, rem = divmod(n_envs, n_tasks)
    return [base + (1 if i < rem else 0) for i in range(n_tasks)]


def build_envs(config: dict, seed: int, device):
    """The configuration's task set (`benchmark`, its train split, goal
    tables from the seed) in one fused engine of `n_envs` slots."""
    from metaworld_tpu_torch import benchmarks, vector
    from metaworld_tpu_torch.envs import registry

    bench = getattr(benchmarks, config["benchmark"])(
        seed=goal_seed(seed), **config.get("benchmark_args", {}))
    names = list(bench.train_classes)
    return vector.FusedBatchedEnvs(
        [registry.get_spec(n, config["reward_function_version"]) for n in names],
        task_counts(config["n_envs"], len(names)),
        [bench.goal_table(n) for n in names],
        goal_visible=config["goal_visible"], one_hot=config["one_hot"],
        max_episode_steps=config["max_episode_steps"],
        task_select=config["task_select"], autoreset=config["autoreset"],
        device=device)
