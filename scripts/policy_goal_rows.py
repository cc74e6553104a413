"""Which goal rows each scripted expert solves, on the JAX package's two
engines: the per-env engine (`envs/core.env_step`, the one the behavioral
bar runs) and the fused lane engine (`FusedBatchedEnvs(physics="lanes")`,
the one the PyTorch port reproduces).

    python scripts/policy_goal_rows.py door-unlock-v3 stick-pull-v3 [--seed 42]

For each task: the goal table of `MT50(seed)` (50 rows), the expert from
the reset of each row for 500 steps, a row solved if any step succeeded.
Prints per task and engine the success rate over the rows and the rows
that failed, to compare with `chip_smoke.py`'s phase 13 on the card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from metaworld_tpu import benchmarks, vector  # noqa: E402
from metaworld_tpu.envs.core import env_reset, env_step  # noqa: E402
from metaworld_tpu.policies import get_policy  # noqa: E402

STEPS = 500


def per_env(spec, name, table):
    policy = get_policy(name)

    @jax.jit
    def rollout(rand_vec, key):
        state, obs = env_reset(spec, rand_vec, key, 1.0)

        def body(carry, _):
            state, obs = carry
            state, out = env_step(spec, state, policy(obs))
            return (state, out.obs), out.success

        (_, _), succ = jax.lax.scan(body, (state, obs), None, length=STEPS)
        return jnp.max(succ)

    keys = jax.random.split(jax.random.PRNGKey(0), table.shape[0])
    return np.asarray(jax.vmap(rollout)(jnp.asarray(table), keys))


def lanes(spec, name, table):
    n = table.shape[0]
    envs = vector.FusedBatchedEnvs([spec], [n], [table], physics="lanes",
                                   task_select="pseudorandom", autoreset=False)
    policy = jax.vmap(get_policy(name))
    state, obs = envs._reset_jit(jax.random.PRNGKey(0), jnp.arange(n, dtype=jnp.int32))

    @jax.jit
    def run(state, obs):
        def body(carry, _):
            state, obs, succ = carry
            state, out = envs._step_impl(state, policy(obs[:, :39]))
            return (state, out["obs"], jnp.maximum(succ, out["success"])), None

        (_, _, succ), _ = jax.lax.scan(body, (state, obs, jnp.zeros(n)), None,
                                       length=STEPS)
        return succ

    return np.asarray(run(state, obs))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="+")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    bench = benchmarks.MT50(seed=args.seed)
    for name in args.names:
        spec, table = bench.train_classes[name], bench.goal_table(name)
        for engine, fn in (("per-env", per_env), ("lanes", lanes)):
            succ = fn(spec, name, table)
            print(f"{name} {engine} engine: success {succ.mean():.4f} over "
                  f"{len(table)} goal rows of MT50(seed={args.seed}); goal rows "
                  f"failed {np.nonzero(succ == 0)[0].tolist()}", flush=True)


if __name__ == "__main__":
    main()
