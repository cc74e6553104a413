"""Agent protocols and the scripted agent (counterpart of
`metaworld_tpu/evaluation.py:21-79`).

Agents follow the reference's protocols (ref metaworld/evaluation.py:12-35)
with batched tensors on the engine's device. `ScriptedAgent` acts for every
slot of a `vector.FusedBatchedEnvs` with the slot's task expert. The
evaluation protocols themselves (`evaluation`, `metalearning_evaluation`)
are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol

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
