"""The port's ScriptedAgent against the JAX package's, and both driving
their own fused engines in lockstep.

* ScriptedAgent on the port's MT10 engine (one-hot ids, 2 slots per task,
  pinned goal rows): the port's agent and the JAX agent act on the same
  observations, the reset's and those of 6 steps of seeded random actions;
  actions within 1e-5.
* Lockstep: the JAX FusedBatchedEnvs(physics="lanes") driven by the JAX
  agent beside the port's engine driven by its own agent, MT10 with 1 slot
  per task and pinned goal rows (task_select="pseudorandom"). Each step
  restarts the port from the JAX state, as test_torch_fused.py does; the
  two agents' actions are held within 1e-4, and the outputs and next state
  as test_torch_fused.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu import evaluation as jevaluation
from metaworld_tpu import vector as jvector
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch import convert, evaluation
from metaworld_tpu_torch import vector as tvector
from tests.test_torch_fused import _compare_out, _compare_state

MT10 = jbench.MT10_LIST
N_GOALS = 10
LOCKSTEP_STEPS = 25


def _engines(per_task, **kw):
    jb, tb = jbench.MT10(seed=0, num_goals=N_GOALS), tbench.MT10(seed=0, num_goals=N_GOALS)
    kw = dict(goal_visible=True, one_hot=True, task_select="pseudorandom", **kw)
    je = jvector.FusedBatchedEnvs(
        [jb.train_classes[n] for n in MT10], [per_task] * len(MT10),
        [jb.goal_table(n) for n in MT10], physics="lanes", **kw)
    te = tvector.FusedBatchedEnvs(
        [tb.train_classes[n] for n in MT10], [per_task] * len(MT10),
        [tb.goal_table(n) for n in MT10], physics="torch", device="cpu", **kw)
    return je, te


def test_scripted_agent_matches_jax():
    je, te = _engines(2)
    j_agent, t_agent = jevaluation.ScriptedAgent(je), evaluation.ScriptedAgent(te)
    rng = np.random.default_rng(0)
    gidx = torch.from_numpy(rng.integers(0, N_GOALS, te.num_envs).astype(np.int32))
    state, obs = te.reset(gidx)
    assert obs.shape == (20, 49)
    for t in range(7):
        ours = t_agent.eval_action(obs).numpy()
        ref = np.asarray(j_agent.eval_action(jnp.asarray(obs.numpy())))
        assert ours.shape == ref.shape == (20, 4)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5, err_msg=f"step {t}")
        act = rng.uniform(-1, 1, (te.num_envs, 4)).astype(np.float32)
        state, out = te.step(state, torch.from_numpy(act))
        obs = out["obs"]
    # the one-hot block is not read
    obs2 = obs.clone()
    obs2[:, 39:] = 1.0
    assert torch.equal(t_agent.eval_action(obs2), t_agent.eval_action(obs))


def test_lockstep_with_the_jax_agent():
    je, te = _engines(1)
    j_agent, t_agent = jevaluation.ScriptedAgent(je), evaluation.ScriptedAgent(te)
    step_j = jax.jit(je._step_impl)
    gidx = np.random.default_rng(1).integers(0, N_GOALS, te.num_envs).astype(np.int32)
    sj, oj = je._reset_jit(jax.random.PRNGKey(0), jnp.asarray(gidx))
    st, ot = te.reset(torch.from_numpy(gidx))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-6)
    worst = 0.0
    for t in range(LOCKSTEP_STEPS):
        st = convert.fused_from_dict(convert.as_dict(sj), "cpu")
        aj = j_agent.eval_action(oj)
        at = t_agent.eval_action(ot)
        err = float(np.abs(at.numpy() - np.asarray(aj)).max())
        worst = max(worst, err)
        assert err <= 1e-4, f"t={t}: actions off by {err:.3e}"
        sj, out_j = step_j(sj, aj)
        st, out_t = te.step(st, at)
        _compare_out(out_j, out_t, f"t={t}")
        _compare_state(sj, st, f"t={t}")
        oj, ot = out_j["obs"], out_t["obs"]
    print(f"{LOCKSTEP_STEPS} lockstep steps: actions off by at most {worst:.3e}")
