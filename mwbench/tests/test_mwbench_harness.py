"""The harness on the CPU at small sizes: the result's keys, the contract's
names and units, a cell, a configuration, a traffic mix and a metric added
as files only, the refusals, and `correct` coming out false under the
control and under each fault a cell can have."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from mwbench import cells, control, run
from mwbench.cells import HERE

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"mt10.rollout": {"config": {"n_envs": 20}},
         "mt10.ppo": {"config": {"n_envs": 20},
                      "traffic": {"ppo": {"rollout": 4, "hidden": 32}}}}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def run_small(cell: str, seed: int, trace: bool = False, root=None, extra=None) -> dict:
    over = SMALL.get(cell, {})
    for k, v in (extra or {}).items():
        over = {**over, k: {**over.get(k, {}), **v}}
    return run.run_cell(cell, seed, 0.2, trace, device="cpu", root=root,
                        overrides=over, t_start=time.perf_counter())


def small_cell(name: str):
    cell = cells.load(name)
    over = SMALL[name]
    cell.config = {**cell.config, **over.get("config", {})}
    traffic = dict(cell.traffic)
    for k, v in over.get("traffic", {}).items():
        traffic[k] = {**traffic[k], **v}
    cell.traffic = traffic
    return cell


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    res = run_small(cell, 2**31 + 101)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert {"env_steps_per_s", "setup_s"} <= set(res["metrics"])
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    traced = run_small(cell, 2**31 + 102, trace=True)
    want = {m["name"] for m in BENCH["per_layer"] if "workloads" in m
            and cell in m["workloads"] and m["source"] == "program_span"}
    assert want and want <= set(traced["metrics"])


def test_names_units_and_moves():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(NAME.match(w[k]) for w in BENCH["workloads"] for k in ("config", "traffic"))
    assert all(NAME.match(k) for c in BENCH["configs"] for k in c["reduced"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    e2e = {m["name"]: set(m.get("workloads", CELLS)) for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] == "env_steps_per_s"
        assert set(m.get("workloads", CELLS)) <= e2e[m["moves"]]
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    for w in BENCH["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert w["chips"] == 1


def test_added_files_are_found(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as new
    files and entries only, in a copy of the benchmark."""
    shutil.copytree(HERE, tmp_path / "mwbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "mwbench" / "configs" / "mt1.json").write_text(json.dumps({
        "name": "mt1", "benchmark": "MT1", "benchmark_args": {"env_name": "pick-place-v3"},
        "reward_function_version": "v2", "goal_visible": True, "one_hot": True,
        "max_episode_steps": 500, "task_select": "random", "autoreset": True,
        "n_envs": 8, "reduced": []}))
    traffic = json.loads((HERE / "traffic" / "rollout.json").read_text())
    traffic["actions"] = {"low": -0.5, "high": 0.5}
    (tmp_path / "mwbench" / "traffic" / "gentle.json").write_text(json.dumps(traffic))
    (tmp_path / "mwbench" / "metrics" / "reward_calls.py").write_text(
        "def read(ctx):\n    return float(len(ctx.spans.get('enqueue_ms', [])))\n")
    bench["configs"].append({"name": "mt1", "source": "https://arxiv.org/abs/1910.10897",
                             "file": "mwbench/configs/mt1.json", "reduced": [],
                             "why": "one task group"})
    bench["workloads"].append({"name": "mt1.gentle", "config": "mt1", "traffic": "gentle",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "reward_calls", "unit": "count", "better": "lower",
                               "source": "program_span", "layer": "device",
                               "moves": "env_steps_per_s", "workloads": ["mt1.gentle"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run.run_cell("mt1.gentle", 7, 0.2, True, device="cpu", root=tmp_path,
                       t_start=time.perf_counter())
    assert res["correct"] and res["metrics"]["reward_calls"]["value"] >= 1
    assert res["attempted"] % 8 == 0


def test_no_device_no_result():
    out = subprocess.run([sys.executable, "-m", "mwbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert out.returncode != 0 and "{" not in out.stdout


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(HERE, tmp_path / "mwbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, '.'); from mwbench import run; "
            f"print(run.run_cell('{CELLS[0]}', 1, 0.1, False, device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout
    assert "metaworld_tpu_torch" in out.stderr


@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith(".rollout")])
def test_control_is_not_correct(cell):
    rows = control.readings(small_cell(cell), 2**31 + 5, 0.2, torch.device("cpu"),
                            ["program", "control"])
    assert [r["correct"] for r in rows] == [True, False]


@pytest.mark.cuda
def test_training_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA device")
    rows = control.readings(small_cell("mt10.ppo"), 2**31 + 5, 0.2, torch.device("cuda"),
                            ["program", "control"])
    assert [r["correct"] for r in rows] == [True, False]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
def test_faults_are_not_correct(cell, fault):
    kind = cells.load(cell).traffic["kind"]
    with control.fault(fault, kind):
        res = run_small(cell, 2**31 + 9)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_after_warm_up_is_not_correct(cell, monkeypatch):
    """The window's own steps are compared: a program that is sound while
    the set-up warms it up and leaves its state unchanged afterwards."""
    from metaworld_tpu_torch import train_ppo, vector

    kind = cells.load(cell).traffic["kind"]
    target, attr = (train_ppo, "learn") if kind == "ppo" else (vector.FusedBatchedEnvs, "step")
    sound, calls = getattr(target, attr), []
    warm = (cells.load(cell).traffic.get("ppo", {}).get("followed_updates")
            or cells.load(cell).traffic["warmup_steps"])

    def later_unchanged(*args, **kw):
        calls.append(1)
        if len(calls) <= warm:
            return sound(*args, **kw)
        if kind == "ppo":
            return torch.zeros(())
        return args[1], sound(*args, **kw)[1]

    monkeypatch.setattr(target, attr, later_unchanged if kind == "ppo"
                        else lambda self, state, actions: later_unchanged(self, state, actions))
    res = run_small(cell, 2**31 + 11)
    assert len(calls) > warm and res["correct"] is False
