"""metalearning_evaluation protocol accounting + MT50 fused-batch smoke
(ref tests/metaworld/test_evaluation.py:106-152, adapt-call accounting)."""

import jax
import numpy as np
import pytest

import metaworld_tpu as mw
from metaworld_tpu.evaluation import metalearning_evaluation


class CountingAgent:
    """Zero-action meta-agent that counts protocol calls."""

    def __init__(self, n):
        self.n = n
        self.init_calls = 0
        self.adapt_calls = 0
        self.adapt_transitions = 0

    def init(self):
        self.init_calls += 1

    def adapt_action(self, obs):
        return np.zeros((self.n, 4))

    def adapt(self, timesteps):
        self.adapt_calls += 1
        self.adapt_transitions += len(timesteps)

    def eval_action(self, obs):
        return np.zeros((self.n, 4))

    def reset(self, env_mask):
        pass


def test_metalearning_evaluation_accounting():
    envs = mw.make_ml_envs("pick-place-v3", seed=0, meta_batch_size=2,
                           terminate_on_success=True, max_episode_steps=40,
                           task_select="pseudorandom")
    agent = CountingAgent(envs.num_envs)
    num_evals, adaptation_steps = 2, 2
    succ, returns, per_task = metalearning_evaluation(
        agent, envs, num_evals=num_evals, adaptation_steps=adaptation_steps,
        adaptation_episodes=1, num_episodes=1,
    )
    assert agent.init_calls == num_evals
    assert agent.adapt_calls == num_evals * adaptation_steps
    assert agent.adapt_transitions > 0
    assert 0.0 <= succ <= 1.0
    assert "pick-place-v3" in per_task


def test_metalearning_task_pinning():
    """Within an eval round the goals seen during adaptation equal the
    goals seen during evaluation; across rounds they change (ref
    evaluation.py:114-125: toggle_sample_tasks_on_reset(False) + one
    sample_tasks() per round)."""

    envs = mw.make_ml_envs_test("pick-place-v3", seed=0, meta_batch_size=2,
                                max_episode_steps=30)
    assert envs.task_select == "pseudorandom"
    import jax

    def goals_of(state):
        if hasattr(state, "groups"):
            return np.concatenate(
                [np.asarray(g.env.rand_vec) for g in state.groups])
        return np.asarray(state.env.rand_vec)

    key = jax.random.PRNGKey(0)
    state, _ = envs.reset(key)
    round_goals = []
    for rnd in range(3):
        state = envs.sample_tasks(state)
        # adaptation reset: pinned goals
        state, obs = envs.reset(jax.random.PRNGKey(10 + rnd), vstate=state)
        adapt_g = goals_of(state)
        # run a few steps incl. autoreset; goals must NOT drift
        for t in range(35):
            state, out = envs.step(state, np.zeros((envs.num_envs, 4)))
        drift_g = goals_of(state)
        np.testing.assert_array_equal(adapt_g, drift_g)
        # evaluation reset reuses the same pinned goals
        state, obs = envs.reset(jax.random.PRNGKey(90 + rnd), vstate=state)
        np.testing.assert_array_equal(adapt_g, goals_of(state))
        round_goals.append(adapt_g)
    assert not np.array_equal(round_goals[0], round_goals[1])
    assert not np.array_equal(round_goals[1], round_goals[2])


@pytest.mark.slow
def test_mt50_fused_batch_smoke():
    """One fused step over ALL 50 tasks (construction + physics + per-task
    tails + autoreset in a single program).

    Slow (199 s in a whole tier-1 run): test_torch_fused_mt50.py::
    test_fused_step_matches_jax builds and steps the JAX MT50 fused engine,
    one-hot ids, all 50 tails and autoreset, for 10 steps in tier-1."""
    envs = mw.make_mt_envs("MT50", seed=0, envs_per_task=1, use_one_hot=True)
    assert envs.num_envs == 50
    assert envs.obs_dim == 39 + 50
    state, obs = envs.reset(jax.random.PRNGKey(0))
    assert obs.shape == (50, 89)
    state, out = envs.step(state, np.zeros((50, 4)))
    r = np.asarray(out["reward"])
    assert r.shape == (50,) and np.isfinite(r).all()
    # one-hot block is a valid permutation over the 50 tasks
    oh = np.asarray(obs[:, 39:])
    assert (oh.sum(axis=1) == 1).all()
    assert (oh.sum(axis=0) == 1).all()
