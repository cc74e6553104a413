"""The port's host tools, each at a few steps on the CPU: `policy_testing`
against the JAX per-env success on the same goal rows, `scaling_bench` over
two CPU shards, `profile_memory`'s keys, `keyboard_control` on piped keys,
and `plot_rewards` / `policy_movies` writing their files. `-m slow` (about
10 min): `policy_testing` at its defaults on the four tasks chip_smoke.py
runs, the failed goal rows equal to the JAX recipe's (printed: the rows
the card is held to)."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu.envs import registry as jregistry
from metaworld_tpu.envs.core import env_reset, env_step
from metaworld_tpu.policies import get_policy as jget_policy
from metaworld_tpu_torch import (keyboard_control, plot_rewards, policy_movies,
                                 policy_testing, profile_memory, scaling_bench)

# the keys scripts/profile_memory.py prints
JAX_MEMORY_KEYS = {"num_envs", "state_bytes", "step_out_bytes", "bytes_per_env",
                   "device_bytes_in_use", "host_rss_bytes",
                   "ref_budget_bytes_per_env"}


def jax_rows(name, n, steps):
    """(n,) success of scripts/policy_testing.py's recipe (the JAX per-env
    engine, vmapped over the rows) on goal rows 0..n-1 of MT1(name,
    seed=42)."""
    spec, policy = jregistry.get_spec(name), jget_policy(name)
    table = jbench.MT1(name, seed=42).goal_table(name)[:n]

    @jax.jit
    def rollout(rand_vec, key):
        state, obs = env_reset(spec, rand_vec, key, 1.0)

        def body(carry, _):
            state, obs = carry
            state, out = env_step(spec, state, policy(obs))
            return (state, out.obs), out.success

        _, succ = jax.lax.scan(body, (state, obs), None, length=steps)
        return jnp.max(succ)

    keys = jax.random.split(jax.random.PRNGKey(0), n)
    return np.asarray(jax.vmap(rollout)(jnp.asarray(table), keys))


def test_policy_testing_matches_jax_per_env_success():
    """reach-v3, goal rows 0..4 of MT1(seed=42), 60 steps: the port's
    success per row equals the JAX recipe's on the same rows."""
    name, n, steps = "reach-v3", 5, 60
    ref = jax_rows(name, n, steps)
    got = policy_testing.run_slots(name, n_goals=n, steps=steps, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < n  # some rows succeed inside 60 steps, some not
    assert policy_testing.run_task.__defaults__[:3] == (50, 42, 500)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["door-unlock-v3", "stick-pull-v3",
                                  "button-press-wall-v3", "door-lock-v3"])
def test_policy_testing_failed_rows_match_jax(name):
    ref = np.flatnonzero(jax_rows(name, 50, 500) == 0).tolist()
    got = policy_testing.run_slots(name, device="cpu")
    print(f"{name}: failed goal rows {ref} of 50 in JAX")
    assert np.flatnonzero(got.numpy() == 0).tolist() == ref


def test_scaling_bench_over_two_cpu_shards(capsys):
    rows = scaling_bench.main(["--device", "cpu", "--sizes", "1,2", "--batch",
                               "4", "--bench", "reach-v3", "--steps", "2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == rows
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["envs"] for r in rows] == [4, 4]
    assert rows[0]["scaling_efficiency"] == 1.0
    assert scaling_bench.shard_devices("cpu", 2) == [torch.device("cpu")] * 2


def test_profile_memory_keeps_the_scripts_keys():
    out = profile_memory.profile("reach-v3", 2, "cpu")
    assert JAX_MEMORY_KEYS <= set(out)
    assert out["num_envs"] == 2
    assert out["bytes_per_env"] == round((out["state_bytes"]
                                          + out["step_out_bytes"]) / 2)
    assert out["device_bytes_in_use"] is None and out["device_peak_bytes"] is None


def test_keyboard_control_with_piped_keys(monkeypatch, capsys, tmp_path):
    # d, d, space (toggle the grip, step), r (reset), space, w; the end of
    # the input quits
    monkeypatch.setattr("sys.stdin", io.StringIO("dd r w"))
    keyboard_control.main(["--device", "cpu", "--repeat", "1",
                           "--save-frames", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    steps = [x for x in out if x.startswith("t=")]
    assert [x.split("hand")[0].strip() for x in steps] == [
        "t=   1", "t=   2", "t=   3", "t=   1", "t=   2"]
    assert out.count("reset") == 1
    frames = sorted(p.name for p in tmp_path.iterdir())
    assert frames == [f"frame_{t:05d}.npy" for t in (1, 2, 3)]
    assert np.load(tmp_path / frames[0]).shape == (480, 480, 3)


def test_plot_rewards_and_policy_movies_write_files(tmp_path):
    rew, succ = plot_rewards.traces(["reach-v3", "push-v3"], steps=3,
                                    device="cpu")
    assert rew.shape == succ.shape == (3, 2) and np.isfinite(rew).all()
    out = tmp_path / "r.png"
    plot_rewards.main(["--envs", "reach-v3", "--steps", "2", "--v1", "--out",
                       str(out), "--device", "cpu"])
    assert out.stat().st_size > 0
    frames, steps = policy_movies.rollout_frames(
        "reach-v3", "corner", 32, 24, 0.1, 42, 0, 2, max_steps=4, device="cpu")
    assert steps == 4 and len(frames) == 2
    assert frames[0].shape == (24, 32, 3) and frames[0].dtype == np.uint8
    policy_movies.write_gif(frames, tmp_path / "m.gif", 20)
    assert (tmp_path / "m.gif").stat().st_size > 0
