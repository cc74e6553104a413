"""Evaluation protocols, agent protocols and the scripted agent
(counterpart of `metaworld_tpu/evaluation.py`).

`evaluation` runs agents on a batch until every slot has `num_episodes`
episodes (ref metaworld/evaluation.py:48-103); `metalearning_evaluation`
cycles through goal sets, collects adaptation episodes, calls agent.adapt,
then evaluates on the same goals (ref :106-169). Agents follow the
reference's protocols (ref :12-35) with batched tensors on the engine's
device. `ScriptedAgent` acts for every slot of a `vector.FusedBatchedEnvs`
with the slot's task expert.

The episode accounting stays on the device, in float64 as the JAX
package's numpy accounting is; each step synchronises the host once, for
the stop test. Where the JAX protocols take a PRNG key, these take a seed
for the engine's generator.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol

import numpy as np
import torch

from metaworld_tpu_torch.policies import get_policy


class Agent(Protocol):
    """(ref evaluation.py:12-19)"""

    def eval_action(self, observations): ...

    def reset(self, env_mask): ...


class MetaLearningAgent(Agent, Protocol):
    """(ref evaluation.py:22-35)"""

    def init(self): ...

    def adapt_action(self, observations): ...

    def adapt(self, timesteps): ...


class Timestep(NamedTuple):
    """(ref evaluation.py:172-179)"""

    observation: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    next_observation: torch.Tensor


class ScriptedAgent:
    """Batched scripted-expert agent: each task's expert acts on
    `obs[a:b, :39]` of the task's slot range; the one-hot block after column
    39 is ignored (the evaluation oracle, ref
    tests/metaworld/test_evaluation.py)."""

    def __init__(self, envs):
        offsets = [0]
        for count in envs.counts:
            offsets.append(offsets[-1] + int(count))
        self._groups = [(get_policy(spec.name), a, b) for spec, a, b in
                        zip(envs.specs, offsets[:-1], offsets[1:])]
        # one call per expert fills the per-device constant cache, so that
        # later calls make no host-to-device copy
        probe = torch.zeros(1, 39, device=envs.device)
        for pol, _, _ in self._groups:
            pol(probe)

    def eval_action(self, observations):
        obs = observations[:, :39]
        return torch.cat([pol(obs[a:b]) for pol, a, b in self._groups])

    def reset(self, env_mask):
        pass


def _per_task(envs, values):
    """{task name: mean of `values` (n,) over the task's slots}, names
    sorted, in float64."""
    names = sorted(set(envs.task_names))
    group_name = torch.tensor([names.index(s.name) for s in envs.specs],
                              device=values.device)
    slot_name = group_name[envs.task_ids.long()]
    sums = torch.zeros(len(names), dtype=torch.float64, device=values.device)
    sums.index_add_(0, slot_name, values)
    counts = torch.bincount(slot_name, minlength=len(names))
    return dict(zip(names, (sums / counts).tolist()))


def evaluation(agent: Agent, eval_envs, num_episodes: int = 50, seed: int = 0,
               max_steps: int | None = None, vstate=None):
    """MT success-rate protocol (ref evaluation.py:48-103): terminate on
    success, count an episode successful if any step succeeded, run until
    every env slot has `num_episodes` episodes.

    Pass `vstate` to evaluate on that state's pinned goals (pseudorandom
    mode), the meta protocol's "same tasks as adaptation" requirement.
    `seed` reseeds the engine's generator at the reset (the JAX protocol's
    key, PRNGKey(0) by default).

    Returns (mean_success_rate, mean_returns, success_per_task,
    returns_per_task) with per-task dicts keyed by env name."""
    assert eval_envs.terminate_on_success, (
        "evaluation expects terminate_on_success=True envs (the reference "
        "toggles it, ref evaluation.py:54)"
    )
    state, obs = eval_envs.reset(seed=seed, vstate=vstate)
    n, dev = eval_envs.num_envs, obs.device
    episodes = torch.zeros(n, dtype=torch.int64, device=dev)
    successes = torch.zeros(n, dtype=torch.float64, device=dev)
    returns_sum = torch.zeros(n, dtype=torch.float64, device=dev)
    cur_success = torch.zeros(n, dtype=torch.float64, device=dev)

    max_steps = max_steps or (num_episodes + 1) * eval_envs.max_episode_steps
    agent.reset(torch.ones(n, dtype=torch.bool, device=dev))
    for _ in range(max_steps):
        actions = agent.eval_action(obs)
        state, out = eval_envs.step(state, actions)
        obs = out["obs"]
        cur_success = torch.maximum(cur_success, out["success"].double())
        done = out["done"]
        # the JAX protocol's `if done.any()` block, masked: with no slot
        # done it changes nothing
        live = (episodes < num_episodes) & done
        successes += torch.where(live, cur_success, 0.0)
        returns_sum += torch.where(live, out["episode_return"].double(), 0.0)
        episodes += live
        cur_success = torch.where(done, 0.0, cur_success)
        any_done, finished = torch.stack(
            [done.any(), (episodes >= num_episodes).all()]).tolist()
        if any_done:
            agent.reset(done)
        if finished:
            break

    eps = episodes.clamp(min=1)
    per_task_success = _per_task(eval_envs, successes / eps)
    per_task_returns = _per_task(eval_envs, returns_sum / eps)
    mean_success = float(np.mean(list(per_task_success.values())))
    mean_returns = float(np.mean(list(per_task_returns.values())))
    return mean_success, mean_returns, per_task_success, per_task_returns


def metalearning_evaluation(
    agent: MetaLearningAgent,
    eval_envs,
    num_evals: int = 10,
    adaptation_steps: int = 1,
    adaptation_episodes: int = 10,
    num_episodes: int = 3,
    seed: int = 0,
):
    """Meta-RL adapt->eval protocol (ref evaluation.py:106-169): one
    pseudo-random task draw per eval round (`sample_tasks`), held fixed
    through the adaptation episodes and the evaluation pass, so the agent
    is evaluated on the tasks it adapted to (ref evaluation.py:114-125).
    The adaptation buffer is a list of `Timestep`s of device tensors; its
    collection stops at the first step where any slot is done.

    Returns (mean success, mean returns, {task: success over the rounds})."""
    assert eval_envs.task_select == "pseudorandom", (
        "metalearning_evaluation needs task_select='pseudorandom' envs "
        "(the reference's PseudoRandomTaskSelectWrapper path)"
    )
    total_success, total_returns = 0.0, 0.0
    task_results: dict[str, list] = {}
    state, _ = eval_envs.reset(seed=seed)

    for ev in range(num_evals):
        # per-round reset and evaluation seeds (the JAX protocol splits keys)
        s_reset, s_eval = seed + 2 * ev + 1, seed + 2 * ev + 2
        state = eval_envs.sample_tasks(state)
        agent.init()
        for _ in range(adaptation_steps):
            state, obs = eval_envs.reset(seed=s_reset, vstate=state)
            buf = []
            for _ in range(adaptation_episodes * eval_envs.max_episode_steps):
                actions = agent.adapt_action(obs)
                state, out = eval_envs.step(state, actions)
                buf.append(Timestep(
                    observation=obs, action=actions, reward=out["reward"],
                    terminated=out["terminated"], truncated=out["truncated"],
                    next_observation=out["obs"]))
                obs = out["obs"]
                if out["done"].any().item():
                    break
            agent.adapt(buf)
        succ, rets, per_s, _ = evaluation(
            agent, eval_envs, num_episodes=num_episodes, seed=s_eval,
            vstate=state)
        total_success += succ
        total_returns += rets
        for t, v in per_s.items():
            task_results.setdefault(t, []).append(v)

    per_task = {t: float(np.mean(v)) for t, v in task_results.items()}
    return total_success / num_evals, total_returns / num_evals, per_task
