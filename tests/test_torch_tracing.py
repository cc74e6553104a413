"""The port's tracer (`metaworld_tpu_torch.tracing`) on the CPU: off, a span
keeps nothing and the fused step's outputs are the same to the bit as with
it on; on, one step, one PPO update and the engine's constructor give the
span trees of the module's list, each child inside its parent; under a
torch.profiler every span is a `user_annotation` event of the chrome trace,
on the profiler's clock up to one offset; `profile_step` reads the spans.
Small engines with the plain physics."""

import argparse
import json

import pytest
import torch

from metaworld_tpu_torch import bench, profile_step, tracing, train_ppo
from metaworld_tpu_torch.types import tree_map

STEP_TREE = {"step": None, "step.physics": "step", "physics.plain": "step.physics",
             "step.guard": "step", "step.tails": "step", "step.autoreset": "step"}


@pytest.fixture(scope="module")
def engine():
    tracing.enable()
    eng = bench.build_envs("cpu", 20, task_select="pseudorandom", max_episode_steps=3)
    built, _ = tracing.take()
    state, _ = eng.reset()
    # slots on every path length, so that some reset on the step
    state = state.replace(env=state.env.replace(
        path_length=torch.arange(eng.num_envs, dtype=torch.int32) % 3))
    gen = torch.Generator().manual_seed(3)
    act = torch.rand(eng.num_envs, 4, generator=gen) * 2 - 1
    return eng, built, state, act


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.take()
    yield
    tracing.take()


def _check_tree(records, parents):
    """Every record's parent is the one `parents` names, and lies around it;
    self time is the duration less the children's."""
    assert all(r.end_ns >= r.start_ns > 0 for r in records)
    own = tracing.self_ns(records)
    for i, r in enumerate(records):
        want = parents[r.name]
        if want is None:
            assert r.parent == -1, r
            continue
        p = records[r.parent]
        assert p.name == want, r
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, (p, r)
        kids = sum(c.end_ns - c.start_ns for c in records if c.parent == i)
        assert own[i] == r.end_ns - r.start_ns - kids >= 0


def test_off_keeps_nothing_and_the_step_is_the_same(engine):
    eng, _, state, act = engine
    assert tracing.span("step") is tracing.span("step.tails")  # the shared no-op
    s_off, o_off = eng.step(state, act)
    assert tracing.take() == ([], 0)
    tracing.enable()
    s_on, o_on = eng.step(state, act)
    records, dropped = tracing.take()
    assert dropped == 0 and [r.name for r in records] == list(STEP_TREE)
    _check_tree(records, STEP_TREE)
    assert bool(o_on["done"].any())
    for k in o_off:
        assert torch.equal(o_off[k], o_on[k]), k
    same = []
    tree_map(lambda a, b: same.append(torch.equal(a, b)), s_off, s_on)
    assert same and all(same)


def test_the_constructor_and_a_ppo_update(engine):
    eng, built, state, _ = engine
    _check_tree(built, {"engine.build": None, "engine.scene_table": "engine.build",
                        "engine.block_table": "engine.build",
                        "engine.reset_table": "engine.build"})
    assert [r.name for r in built] == ["engine.build", "engine.scene_table",
                                       "engine.block_table", "engine.reset_table"]
    torch.manual_seed(0)
    model = train_ppo.ActorCritic(eng.obs_dim, 8)
    opt, sched = train_ppo.make_optimizer(model, 1e-3, 4)
    args = argparse.Namespace(rollout=1, gamma=0.99, lam=0.95, epochs=1,
                              minibatches=2, clip=0.2)
    obs = eng.reset()[1]
    tracing.enable()
    train_ppo.update(model, opt, sched, eng, state, obs, torch.Generator().manual_seed(1),
                     args)
    records, _ = tracing.take()
    _check_tree(records, {**STEP_TREE, "step": "ppo.rollout", "ppo.rollout": None,
                          "ppo.policy": "ppo.rollout", "ppo.gae": None,
                          "ppo.learn": None, "ppo.minibatch": "ppo.learn"})
    names = [r.name for r in records]
    assert [n for n in names if n.startswith("ppo.")] == [
        "ppo.rollout", "ppo.policy", "ppo.gae", "ppo.learn", "ppo.minibatch",
        "ppo.minibatch"]
    assert names.count("step") == 1


def test_cap_and_a_take_inside_a_span(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 2)
    tracing.enable()
    with tracing.span("a"):
        with tracing.span("b"):
            with tracing.span("c"):
                pass
        with tracing.span("d"):
            pass
    records, dropped = tracing.take()
    assert [(r.name, r.parent) for r in records] == [("a", -1), ("b", 0)] and dropped == 2
    tracing.enable()
    with tracing.span("a"):
        taken, _ = tracing.take()
        tracing.enable()
        with tracing.span("b"):
            pass
    records, _ = tracing.take()
    assert [(r.name, r.end_ns) for r in taken] == [("a", 0)]
    assert [(r.name, r.parent) for r in records] == [("b", -1)]


def test_spans_are_profiler_annotations_on_its_clock(engine, tmp_path):
    """A step with the records kept, then spans with the tracer off: each
    is a `user_annotation` event, and each record lies inside its event."""
    eng, _, state, act = engine
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.enable()
        eng.step(state, act)
        records, _ = tracing.take()
        for name in ("ppo.gae", "physics.load"):
            with tracing.span(name):
                pass
    assert tracing.take() == ([], 0)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    ann = {e["name"]: e for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"}
    assert set(STEP_TREE) | {"ppo.gae", "physics.load"} <= set(ann)
    pairs = [(r, ann[r.name]) for r in records]
    offsets = sorted(float(e["ts"]) * 1e3 - r.start_ns for r, e in pairs)
    off = offsets[len(offsets) // 2]
    slack = 1e6  # 1 ms, for a loaded worker
    for r, e in pairs:
        t0, t1 = float(e["ts"]) * 1e3, (float(e["ts"]) + float(e["dur"])) * 1e3
        assert t0 - slack <= r.start_ns + off and r.end_ns + off <= t1 + slack, r.name


def test_profile_step_reads_the_spans(capsys):
    profile_step.main(["--device", "cpu", "--envs", "10", "--steps", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line["setup_ms"]) == ["engine.build", "engine.scene_table",
                                      "engine.block_table", "engine.reset_table"]
    assert list(line["span_ms"]) == list(STEP_TREE)
    step = line["span_ms"]["step"]
    assert 0 < step["self"] < step["total"] <= 1.5 * line["wall_ms_per_step"]
    kids = sum(v["total"] for k, v in line["span_ms"].items() if STEP_TREE[k] == "step")
    assert step["total"] - kids == pytest.approx(step["self"], abs=1e-6)
