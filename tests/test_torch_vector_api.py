"""The fused engine's interface above the step, against the JAX package's
FusedBatchedEnvs: `task_names` and `env_task_names` on MT10 and on ML45's
test split; `sample_tasks` bit for bit over 12 rounds with 5 goals per
task, so every slot wraps and reshuffles twice; `reset(vstate=...)`
pinning `rand_vec` to the same goal-table rows; and `reset(seed=...)`
reseeding the port's generator (the JAX engine's key has no port
counterpart to compare with: C4 of ROADMAP.md).
"""

import jax
import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu import vector as jvector
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch import vector as tvector

N_GOALS = 5
ROUNDS = 12


def _pair(bench_fn, split="train", per_task=2, **kw):
    je = jvector.from_benchmark(bench_fn(jbench), split=split,
                                envs_per_task=per_task, **kw)
    te = tvector.from_benchmark(bench_fn(tbench), split=split,
                                envs_per_task=per_task, device="cpu", **kw)
    return je, te


@pytest.fixture(scope="module")
def mt10():
    return _pair(lambda b: b.MT10(seed=0, num_goals=N_GOALS),
                 task_select="pseudorandom")


@pytest.mark.parametrize("which", ["mt10", "ml45-test"])
def test_task_names_match_jax(which, mt10):
    if which == "mt10":
        je, te = mt10
    else:
        je, te = _pair(lambda b: b.ML45(seed=0, num_goals=2), split="test",
                       per_task=3)
    assert te.task_names == je.task_names
    assert te.env_task_names() == je.env_task_names()
    assert len(te.env_task_names()) == te.num_envs


def test_sample_tasks_bit_equal(mt10):
    je, te = mt10
    sj, _ = je.reset(jax.random.PRNGKey(0))
    st, _ = te.reset()
    for r in range(ROUNDS):
        sj = je.sample_tasks(sj)
        st = te.sample_tasks(st)
        assert st.goal_idx.dtype == torch.int32
        np.testing.assert_array_equal(st.goal_idx.numpy(), np.asarray(sj.goal_idx),
                                      err_msg=f"round {r}")
    for cj, ct in zip(je._prg_cursor, te._prg_cursor):
        np.testing.assert_array_equal(ct, cj)


def test_sample_tasks_cycles_per_slot():
    _, te = _pair(lambda b: b.MT10(seed=1, num_goals=N_GOALS),
                  task_select="pseudorandom")
    st, _ = te.reset()
    seen = []
    for _ in range(2 * N_GOALS):
        st = te.sample_tasks(st)
        seen.append(st.goal_idx.numpy())
    seen = np.stack(seen)
    for block in (seen[:N_GOALS], seen[N_GOALS:]):
        np.testing.assert_array_equal(np.sort(block, axis=0),
                                      np.arange(N_GOALS)[:, None].repeat(te.num_envs, 1))


def test_reset_vstate_pins_rand_vec(mt10):
    je, te = mt10
    sj, _ = je.reset(jax.random.PRNGKey(0))
    st, _ = te.reset()
    for _ in range(3):
        sj, st = je.sample_tasks(sj), te.sample_tasks(st)
    sj2, oj = je.reset(jax.random.PRNGKey(5), vstate=sj)
    st2, ot = te.reset(seed=5, vstate=st)
    assert torch.equal(st2.goal_idx, st.goal_idx)
    np.testing.assert_array_equal(st2.env.rand_vec.numpy(),
                                  np.asarray(sj2.env.rand_vec, dtype=np.float32))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-6)
    # the same rows through goal_idx=, and vstate with goal_idx is refused
    st3, _ = te.reset(goal_idx=st.goal_idx)
    assert torch.equal(st3.env.rand_vec, st2.env.rand_vec)
    with pytest.raises(AssertionError):
        te.reset(vstate=st, goal_idx=st.goal_idx)


def test_reset_seed_reseeds_random_draws():
    te = tvector.from_benchmark(tbench.MT10(seed=0, num_goals=N_GOALS),
                                envs_per_task=8, device="cpu")
    a, _ = te.reset(seed=3)
    b, _ = te.reset()
    c, _ = te.reset(seed=3)
    assert torch.equal(a.env.rand_vec, c.env.rand_vec)
    assert not torch.equal(a.env.rand_vec, b.env.rand_vec)
    with pytest.raises(AssertionError):
        te.sample_tasks(a)   # random mode has no pinned rows to advance


@pytest.mark.parametrize("physics", ["auto", "torch"])
def test_cpu_engine_steps_eagerly_and_never_captures(physics):
    """Only an engine with the CUDA kernel captures its step as a graph: on
    the CPU (the plain physics) every step runs op by op, is counted as
    eager, and leaves the graph counters at zero; a new step setting
    captures nothing either."""
    envs = tvector.from_benchmark(tbench.MT1("reach-v3", seed=0, num_goals=2),
                                  envs_per_task=2, physics=physics, device="cpu")
    assert envs.physics == "torch" and envs._graph is None
    tvector.reset_counts()
    state, _ = envs.reset(seed=0)
    for _ in range(2):
        state, _ = envs.step(state, torch.zeros(envs.num_envs, 4))
    assert (tvector.graph_captures, tvector.graph_replays, tvector.eager_steps,
            tvector.state_copy_ins) == (0, 0, 2, 0)
    assert tvector.hit_share() == 0.0
    envs.terminate_on_success = True
    assert envs._graph is None and tvector.graph_captures == 0
    assert envs.graph_pool_bytes == envs.graph_buffer_bytes == 0
