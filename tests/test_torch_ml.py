"""The meta-RL benchmarks of the port: ML1, ML10, ML25, ML45 and CustomML
goal tables bit for bit against the JAX package on both splits, and
`vector.from_benchmark(split="test")` on ML10 against the JAX
`from_benchmark` with `terminate_on_success=True` (the test split's
setting in the JAX package's `make_ml_envs`) and with `autoreset=False`.

Engines: 2 slots per ML10 test task, one-hot ids, pinned goal rows and
max_episode_steps=4; the checks and tolerances are test_torch_fused.py's
(observations 1e-5; rewards, returns and metrics 1e-5 relative or 1e-6
absolute; flags and counters exact). The test split is partially
observable, so the goal block of every observation is zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu import vector as jvector
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch import convert
from metaworld_tpu_torch import vector as tvector
from tests.test_torch_fused import _compare_out, _compare_state, check_fused

N_GOALS = 5
KW = dict(one_hot=True, max_episode_steps=4, task_select="pseudorandom")


def _benchmarks(seed):
    """(name, JAX benchmark, port benchmark) of each meta-RL constructor."""
    custom = (["reach-v3", "hammer-v3", "soccer-v3"],
              ["box-close-v3", "handle-pull-side-v3"])
    return [
        ("ML1", jbench.ML1("peg-unplug-side-v3", seed=seed),
         tbench.ML1("peg-unplug-side-v3", seed=seed)),
        ("ML10", jbench.ML10(seed=seed), tbench.ML10(seed=seed)),
        ("ML25", jbench.ML25(seed=seed), tbench.ML25(seed=seed)),
        ("ML45", jbench.ML45(seed=seed), tbench.ML45(seed=seed)),
        ("CustomML", jbench.CustomML(*custom, seed=seed),
         tbench.CustomML(*custom, seed=seed)),
    ]


def test_ml_lists_match_jax():
    for name in ("ML10_TRAIN", "ML10_TEST", "ML25_TRAIN", "ML25_TEST",
                 "ML45_TRAIN", "ML45_TEST", "MT50_LIST"):
        assert getattr(tbench, name) == getattr(jbench, name), name
    assert len(tbench.ML45_TRAIN) == 45


@pytest.mark.parametrize("seed", [0, 42])
def test_ml_goal_tables_bit_equal(seed):
    for what, jb, tb in _benchmarks(seed):
        for split in ("train", "test"):
            jc = jb.train_classes if split == "train" else jb.test_classes
            tc = tb.train_classes if split == "train" else tb.test_classes
            assert list(tc) == list(jc), (what, split)
            jt = jb.train_tasks if split == "train" else jb.test_tasks
            tt = tb.train_tasks if split == "train" else tb.test_tasks
            assert [t.partially_observable for t in tt] == [
                t.partially_observable for t in jt]
            for name in jc:
                x, y = tb.goal_table(name, split), jb.goal_table(name, split)
                assert x.dtype == y.dtype and x.shape == y.shape == (50, 12)
                np.testing.assert_array_equal(x, y, err_msg=f"{what} {split} {name}")
    # ML1 draws its test goals from seed + 1
    _, _, ml1 = _benchmarks(seed)[0]
    assert not np.array_equal(ml1.goal_table("peg-unplug-side-v3", "train"),
                              ml1.goal_table("peg-unplug-side-v3", "test"))


def test_custom_ml_rejects_overlap():
    with pytest.raises(AssertionError):
        tbench.CustomML(["reach-v3"], ["reach-v3"], seed=0)


class _Recorder:
    """The port's engine, keeping every step's outputs."""

    def __init__(self, engine):
        self.engine, self.outs = engine, []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def step(self, state, action):
        state, out = self.engine.step(state, action)
        self.outs.append(out)
        return state, out


@functools.lru_cache(maxsize=None)
def _ml10():
    return jbench.ML10(seed=0, num_goals=N_GOALS), tbench.ML10(seed=0, num_goals=N_GOALS)


@functools.lru_cache(maxsize=None)
def _engines(**kw):
    """The JAX and the port's engine on ML10's test split, and the jitted
    JAX step; shared by the tests that ask for the same options (the
    engines hold no state between steps)."""
    jb, tb = _ml10()
    je = jvector.from_benchmark(jb, split="test", envs_per_task=2,
                                physics="lanes", **KW, **kw)
    te = tvector.from_benchmark(tb, split="test", envs_per_task=2,
                                physics="torch", device="cpu", **KW, **kw)
    return je, te, jax.jit(je._step_impl)


def test_from_benchmark_takes_the_split():
    _, tb = _ml10()
    te = tvector.from_benchmark(tb, split="test", envs_per_task=2, device="cpu")
    assert [s.name for s in te.specs] == tbench.ML10_TEST
    assert te.goal_visible == [0.0] * 5
    train = tvector.from_benchmark(tb, envs_per_task=1, device="cpu")
    assert [s.name for s in train.specs] == tbench.ML10_TRAIN
    mt = tvector.from_benchmark(tbench.MT10(seed=0, num_goals=2), device="cpu")
    assert mt.goal_visible == [1.0] * 10
    # the reset table holds each test task's rows of the test goal table
    for i, name in enumerate(tbench.ML10_TEST):
        np.testing.assert_array_equal(
            te._reset_env.rand_vec[N_GOALS * i:N_GOALS * (i + 1)].numpy(),
            tb.goal_table(name, "test").astype(np.float32), err_msg=name)


def test_ml10_test_split_matches_jax():
    je, te, step_j = _engines(terminate_on_success=True)
    rec = _Recorder(te)
    check_fused(je, rec, step_j, n_goals=N_GOALS, steps=12)
    obs = torch.stack([o["obs"] for o in rec.outs])
    assert obs.shape[-1] == 39 + 5
    assert bool((obs[..., 36:39] == 0).all())  # the goal is hidden


def test_terminate_on_success_matches_jax():
    """Door-close slots started with the door shut succeed on the first
    step: the success terminates their episodes and the next step resets
    them, on both sides alike."""
    je, te, step_j = _engines(terminate_on_success=True)
    sj, _ = je._reset_jit(jax.random.PRNGKey(0),
                          jnp.zeros(te.num_envs, dtype=jnp.int32))
    k = 2 * tbench.ML10_TEST.index("door-close-v3")
    sj = sj.replace(env=sj.env.replace(sim=sj.env.sim.replace(
        joint_q=sj.env.sim.joint_q.at[k:k + 2, 0].set(1.5708))))
    st = convert.fused_from_dict(convert.as_dict(sj), "cpu")
    act = np.zeros((te.num_envs, 4), np.float32)
    for t in range(2):
        sj, out_j = step_j(sj, jnp.asarray(act))
        st, out_t = te.step(st, torch.from_numpy(act))
        _compare_out(out_j, out_t, f"t={t}")
        _compare_state(sj, st, f"t={t}")
        if t == 0:
            assert bool(out_t["success"][k:k + 2].all())
            assert torch.equal(out_t["terminated"], out_t["success"] > 0)
            assert torch.equal(st.pending_reset, out_t["done"])
    assert out_t["episode_length"][k:k + 2].tolist() == [1, 1]
    assert not bool(out_t["terminated"][k:k + 2].any())


def test_no_autoreset_matches_jax():
    je, te, step_j = _engines(terminate_on_success=True, autoreset=False)
    rec = _Recorder(te)
    states = check_fused(je, rec, step_j, n_goals=N_GOALS, steps=8, crossings=0)
    assert not any(bool(s.pending_reset.any()) for s in states)
    lengths = torch.stack([o["episode_length"] for o in rec.outs])
    assert lengths[:, 0].tolist() == list(range(1, 9))
    assert bool(torch.stack([o["truncated"] for o in rec.outs])[3:].all())
