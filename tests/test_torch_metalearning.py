"""The port's `metalearning_evaluation()`: the accounting and task-pinning
patterns of tests/test_metalearning.py on the port, then the port against
the JAX package's protocol on `make_ml_envs_test("ML10", seed=0,
meta_batch_size=5, max_episode_steps=100)` (1 slot per test task, goal
hidden): both engines are wrapped to record the pinned goal rows of every
reset, and a meta-agent that acts with each package's ScriptedAgent runs 2
rounds. With the goal hidden, 30-step episodes succeed on no task; at 100
drawer-open and shelf-place succeed and the other three do not, so the
comparison sees both outcomes. The per-round goal rows must be equal, the
adaptation buffers as long, the per-task success equal and the mean
returns within rtol 1e-4 (test_torch_evaluation.py's tolerance).
"""

import numpy as np
import pytest
import torch

import metaworld_tpu as jmw
import metaworld_tpu_torch as tmw
from metaworld_tpu import evaluation as jevaluation
from metaworld_tpu_torch import evaluation

ML10_STEPS = 100


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
        return torch.zeros(self.n, 4)

    def adapt(self, timesteps):
        self.adapt_calls += 1
        self.adapt_transitions += len(timesteps)
        assert all(isinstance(t, evaluation.Timestep) for t in timesteps)
        assert timesteps[0].observation.shape == (self.n, 39)

    def eval_action(self, obs):
        return torch.zeros(self.n, 4)

    def reset(self, env_mask):
        pass


def test_metalearning_evaluation_accounting():
    envs = tmw.make_ml_envs("pick-place-v3", seed=0, meta_batch_size=2,
                            terminate_on_success=True, max_episode_steps=20,
                            task_select="pseudorandom", device="cpu")
    agent = CountingAgent(envs.num_envs)
    num_evals, adaptation_steps = 2, 2
    succ, returns, per_task = evaluation.metalearning_evaluation(
        agent, envs, num_evals=num_evals, adaptation_steps=adaptation_steps,
        adaptation_episodes=1, num_episodes=1,
    )
    assert agent.init_calls == num_evals
    assert agent.adapt_calls == num_evals * adaptation_steps
    assert agent.adapt_transitions > 0
    assert 0.0 <= succ <= 1.0
    assert list(per_task) == ["pick-place-v3"]


def test_metalearning_needs_pseudorandom():
    envs = tmw.make_ml_envs("reach-v3", seed=0, meta_batch_size=2,
                            terminate_on_success=True, device="cpu")
    with pytest.raises(AssertionError):
        evaluation.metalearning_evaluation(CountingAgent(2), envs, num_evals=1)


def test_metalearning_task_pinning():
    """Within an eval round the goals seen during adaptation equal the
    goals seen during evaluation; across rounds they change."""
    envs = tmw.make_ml_envs_test("pick-place-v3", seed=0, meta_batch_size=2,
                                 max_episode_steps=30, device="cpu")
    assert envs.task_select == "pseudorandom" and envs.terminate_on_success
    state, _ = envs.reset()
    round_goals = []
    for rnd in range(3):
        state = envs.sample_tasks(state)
        state, obs = envs.reset(seed=10 + rnd, vstate=state)
        assert torch.all(obs[:, 36:39] == 0)
        adapt_g = state.env.rand_vec.clone()
        # a few steps including an autoreset: goals must not drift
        for _ in range(35):
            state, out = envs.step(state, torch.zeros(envs.num_envs, 4))
        assert torch.equal(adapt_g, state.env.rand_vec)
        state, obs = envs.reset(seed=90 + rnd, vstate=state)
        assert torch.equal(adapt_g, state.env.rand_vec)
        round_goals.append(adapt_g)
    assert not torch.equal(round_goals[0], round_goals[1])
    assert not torch.equal(round_goals[1], round_goals[2])


class Recorder:
    """Delegates to an engine and records the pinned goal rows of every
    reset."""

    def __init__(self, envs):
        self.envs = envs
        self.goal_rows = []

    def __getattr__(self, name):
        return getattr(self.envs, name)

    def reset(self, *args, **kwargs):
        state, obs = self.envs.reset(*args, **kwargs)
        self.goal_rows.append(np.asarray(state.goal_idx).copy())
        return state, obs


class ScriptedMetaAgent:
    """Acts with a ScriptedAgent when adapting and evaluating; counts the
    protocol's calls."""

    def __init__(self, scripted):
        self.scripted = scripted
        self.calls = {"init": 0, "adapt": 0, "transitions": 0}

    def init(self):
        self.calls["init"] += 1

    def adapt_action(self, obs):
        return self.scripted.eval_action(obs)

    eval_action = adapt_action

    def adapt(self, timesteps):
        self.calls["adapt"] += 1
        self.calls["transitions"] += len(timesteps)

    def reset(self, env_mask):
        pass


def test_metalearning_matches_jax():
    kw = dict(seed=0, meta_batch_size=5, max_episode_steps=ML10_STEPS)
    je = Recorder(jmw.make_ml_envs_test("ML10", physics="lanes", **kw))
    te = Recorder(tmw.make_ml_envs_test("ML10", physics="torch", device="cpu",
                                        **kw))
    aj = ScriptedMetaAgent(jevaluation.ScriptedAgent(je.envs))
    at = ScriptedMetaAgent(evaluation.ScriptedAgent(te.envs))
    args = dict(num_evals=2, adaptation_steps=1, adaptation_episodes=1,
                num_episodes=1)
    rj = jevaluation.metalearning_evaluation(aj, je, **args)
    rt = evaluation.metalearning_evaluation(at, te, **args)
    print("JAX:", rj, aj.calls)
    assert at.calls == aj.calls
    assert at.calls["init"] == at.calls["adapt"] == 2
    # first reset, then (adaptation, evaluation) per round
    assert len(te.goal_rows) == len(je.goal_rows) == 5
    for gt, gj in zip(te.goal_rows, je.goal_rows):
        np.testing.assert_array_equal(gt, gj)
    for rnd in range(2):
        np.testing.assert_array_equal(te.goal_rows[1 + 2 * rnd],
                                      te.goal_rows[2 + 2 * rnd])
    assert np.all(te.goal_rows[1] != te.goal_rows[3])
    assert list(rt[2]) == list(rj[2])
    assert rt[2] == rj[2]
    assert rt[0] == rj[0]
    assert rt[1] == pytest.approx(rj[1], rel=1e-4)
