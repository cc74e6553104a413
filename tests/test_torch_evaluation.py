"""The port's `evaluation()` against the JAX package's.

* Accounting: both protocols drive one scripted engine whose done, success
  and return streams come from a numpy seed (episodes counted only while
  under `num_episodes`, `cur_success` a running max cleared on done, the
  stop test, `max_steps`), so the physics plays no part; per-task success
  and returns held at 1e-12 (float64 sums in another order).
* MT10(seed=42), 1 slot per task on numpy-chosen pinned goal rows,
  terminate_on_success, max_episode_steps=100, num_episodes=2: the JAX
  FusedBatchedEnvs(physics="lanes") with the JAX ScriptedAgent against the
  port's engine (plain PyTorch physics) with its own. On these rows the
  experts first succeed at steps 48-93 (the JAX engine), so episodes of
  40 steps would succeed nowhere; at 100 every task succeeds and its
  episodes end at different steps. Per-task success equal; per-task
  returns at rtol 1e-4: the two physics agree to about 1e-5 per step
  (test_torch_fused.py), and a return sums up to 100 rewards of order
  1-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu import evaluation as jevaluation
from metaworld_tpu import vector as jvector
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch import evaluation
from metaworld_tpu_torch import vector as tvector

RET_RTOL = 1e-4


class _Spec:
    def __init__(self, name):
        self.name = name


class ScriptedEngine:
    """An engine that replays done / success / return streams: 3 tasks with
    2, 3 and 1 slots; `torch_out` picks the port's tensors or the JAX
    protocol's numpy arrays."""

    def __init__(self, seed, torch_out, steps=60, max_episode_steps=7):
        rng = np.random.default_rng(seed)
        self.specs = [_Spec("b-task"), _Spec("a-task"), _Spec("c-task")]
        self.counts = [2, 3, 1]
        self.num_envs = 6
        self.task_ids = torch.tensor([0, 0, 1, 1, 1, 2], dtype=torch.int32)
        self.terminate_on_success = True
        self.max_episode_steps = max_episode_steps
        self.done = rng.random((steps, 6)) < 0.25
        self.success = (rng.random((steps, 6)) < 0.2).astype(np.float32)
        self.ret = rng.normal(size=(steps, 6)).astype(np.float32) * 10
        self.torch_out = torch_out
        self.resets = 0

    @property
    def task_names(self):
        return [s.name for s in self.specs]

    def env_task_names(self):
        return [s.name for s, c in zip(self.specs, self.counts) for _ in range(c)]

    def reset(self, key=None, vstate=None, seed=None):
        self.resets += 1
        return 0, self._wrap(np.zeros((6, 3), np.float32))

    def _wrap(self, a):
        return torch.from_numpy(a) if self.torch_out else a

    def step(self, t, actions):
        out = {"obs": np.full((6, 3), t, np.float32), "success": self.success[t],
               "done": self.done[t], "episode_return": self.ret[t]}
        return t + 1, {k: self._wrap(v) for k, v in out.items()}


class CountingAgent:
    def __init__(self):
        self.resets = []

    def eval_action(self, obs):
        return obs[:, :1]

    def reset(self, mask):
        self.resets.append(np.asarray(mask).copy())


@pytest.mark.parametrize("num_episodes,max_steps", [(1, None), (2, None), (3, None),
                                                    (2, 5)])
def test_accounting_matches_jax(num_episodes, max_steps):
    ej, et = ScriptedEngine(0, False), ScriptedEngine(0, True)
    aj, at = CountingAgent(), CountingAgent()
    rj = jevaluation.evaluation(aj, ej, num_episodes=num_episodes,
                                max_steps=max_steps)
    rt = evaluation.evaluation(at, et, num_episodes=num_episodes,
                               max_steps=max_steps)
    assert list(rt[2]) == list(rj[2]) == ["a-task", "b-task", "c-task"]
    for a, b in ((rt[0], rj[0]), (rt[1], rj[1])):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-12)
    for k in rj[2]:
        assert rt[2][k] == pytest.approx(rj[2][k], rel=1e-12, abs=1e-12)
        assert rt[3][k] == pytest.approx(rj[3][k], rel=1e-12, abs=1e-12)
    # the agent is reset on the same masks at the same steps
    assert len(at.resets) == len(aj.resets)
    for a, b in zip(at.resets, aj.resets):
        np.testing.assert_array_equal(a, b)


def test_requires_terminate_on_success():
    eng = ScriptedEngine(0, True)
    eng.terminate_on_success = False
    with pytest.raises(AssertionError):
        evaluation.evaluation(CountingAgent(), eng)


@pytest.fixture(scope="module")
def mt10_results():
    kw = dict(envs_per_task=1, terminate_on_success=True, max_episode_steps=100,
              task_select="pseudorandom")
    je = jvector.from_benchmark(jbench.MT10(seed=42), physics="lanes", **kw)
    te = tvector.from_benchmark(tbench.MT10(seed=42), physics="torch",
                                device="cpu", **kw)
    gidx = np.random.default_rng(7).integers(0, 50, te.num_envs).astype(np.int32)
    sj, _ = je.reset(jax.random.PRNGKey(0))
    sj = sj.replace(goal_idx=jnp.asarray(gidx))
    st, _ = te.reset(goal_idx=torch.from_numpy(gidx))
    rj = jevaluation.evaluation(jevaluation.ScriptedAgent(je), je,
                                num_episodes=2, vstate=sj)
    rt = evaluation.evaluation(evaluation.ScriptedAgent(te), te,
                               num_episodes=2, vstate=st)
    return rj, rt


def test_mt10_success_matches_jax(mt10_results):
    rj, rt = mt10_results
    print("per-task success (JAX):", rj[2], "returns:", rj[3])
    assert list(rt[2]) == list(rj[2]) == sorted(jbench.MT10_LIST)
    assert rt[2] == rj[2]
    assert rt[0] == rj[0]


def test_mt10_returns_match_jax(mt10_results):
    rj, rt = mt10_results
    for k in rj[3]:
        assert rt[3][k] == pytest.approx(rj[3][k], rel=RET_RTOL), k
    assert rt[1] == pytest.approx(rj[1], rel=RET_RTOL)
