"""The port's throughput entry point (`metaworld_tpu_torch.bench`) against
the JAX package's `bench.py`, on the CPU: the same layout, the same result
line, a loud exit without a card; and the per-device cache key that lets a
freshly built engine's first step find the constants its constructor made
(on the card, a miss copies them from host memory, which synchronises)."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu_torch import bench
from metaworld_tpu_torch.benchmarks import MT10_LIST
from metaworld_tpu_torch.devices import device_key
from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.physics import engine_lanes

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_bench():
    """The repo root's bench.py (the JAX package's throughput script)."""
    spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_envs_is_the_jax_bench_layout(jax_bench, monkeypatch):
    """N = 40: the JAX bench's task order, `divmod` counts and goal tables
    (bit-equal to MT10(seed=0)'s), observations 39 + 10 wide."""
    monkeypatch.setattr(jax_bench, "BATCH", 40)
    ref = jax_bench.build_envs()
    envs = bench.build_envs("cpu", 40)
    assert envs.task_names == ref.task_names
    assert envs.counts == list(ref.counts) == [4] * 10
    assert envs.obs_dim == ref.obs_dim == 49
    assert envs.one_hot and envs.autoreset and envs.task_select == "random"
    assert envs.goal_visible == [1.0] * 10
    mt10 = jbench.MT10(seed=0)
    for name, table in zip(envs.task_names, envs.goal_tables):
        want = mt10.goal_table(name)
        assert table.dtype == want.dtype
        np.testing.assert_array_equal(table, want)


def test_counts_at_full_width_are_bench_py_formula(jax_bench):
    n, k = jax_bench.BATCH, 10
    base, rem = divmod(n, k)
    assert (bench.N_ENVS, bench.STEPS) == (jax_bench.BATCH, jax_bench.SCAN_STEPS)
    assert bench.task_counts(n, k) == [base + (1 if i < rem else 0) for i in range(k)]
    assert bench.task_counts(n, k) == [13108, 13108] + [13107] * 8


def test_main_on_the_cpu_prints_bench_py_result_line(capsys):
    got = bench.main(["--device", "cpu", "--envs", "40", "--steps", "1",
                      "--rounds", "2"])
    lines = capsys.readouterr().out.splitlines()
    last = json.loads(lines[-1])
    assert last == got
    assert list(last) == ["metric", "value", "unit", "vs_baseline"]
    assert last["metric"] == "env_steps_per_s_mt10_b40"
    assert last["unit"] == "steps/s" and last["value"] > 0
    assert last["vs_baseline"] == round(last["value"] / 1e6, 3)
    reward = [x for x in lines if "summed reward over the timed rounds" in x]
    assert len(reward) == 1
    assert np.isfinite(float(reward[0].split("rounds ")[1].split(";")[0]))


def test_main_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code not in (0, None)


def test_device_key_names_one_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    key = device_key("cuda")
    assert key == device_key("cuda:0") == device_key(torch.device("cuda", 0))
    assert key == "cuda:0"
    assert device_key("cpu") == device_key(torch.device("cpu")) == \
        device_key("cpu:0") == device_key(torch.zeros(1, device="cpu:0").device) \
        == "cpu"


@pytest.mark.parametrize("device", ["cpu", "cpu:0"])
def test_first_step_of_a_fresh_engine_adds_no_cache_entry(device, monkeypatch):
    """The constructor fills every per-device cache the step reads, under
    the key the step looks up by a tensor's device: "cpu:0" is named as a
    CUDA device with no index is, and its tensors report "cpu"."""
    monkeypatch.setattr(engine_lanes, "_REACH_CACHE", {})
    specs = [registry.get_spec(n) for n in MT10_LIST]
    saved = [dict(s._cache) for s in specs]
    try:
        for s in specs:
            s._cache.clear()
        envs = bench.build_envs(device, 20)
        assert all(a is b for a, b in zip(envs.specs, specs))
        before = ([set(s._cache) for s in specs], set(engine_lanes._REACH_CACHE))
        state, _ = envs.reset(seed=0)
        envs.step(state, torch.zeros(envs.num_envs, 4))
        after = ([set(s._cache) for s in specs], set(engine_lanes._REACH_CACHE))
    finally:
        for s, c in zip(specs, saved):
            s._cache.clear()
            s._cache.update(c)
    assert after == before
    assert before[1] == {device_key(device)}
