"""The fused multi-task engine: one physics step over the whole batch, then
the per-task observation/reward tails, the non-finite guard, episode
statistics and NEXT_STEP autoreset.

Counterpart of `metaworld_tpu/vector.py::FusedBatchedEnvs` (vector.py:298-499
of the JAX package). Differences in form, not in result:

  * Scenes are a per-task table (`cuda_step.SceneTable`) indexed by a
    per-slot task id, which is what the CUDA kernel reads.
  * Autoreset never asks the host whether any slot is pending (the JAX code
    gates it behind `lax.cond(pending.any())`): a reset is a pure function
    of the slot's goal row, because every goal-table row already passes its
    task's rejection test, so the engine builds one table of reset states
    and observations per (task, goal row) at construction and every step
    gathers the pending slots' rows and selects them with `torch.where`.
  * Random goal draws come from a `torch.Generator` on the engine's device;
    there are no per-slot PRNG keys, and `reset(seed=...)` reseeds the
    generator where the JAX engine takes a key. `task_select="pseudorandom"`
    pins each slot to `goal_idx`, which lets a test pin both implementations
    to the same rows; `sample_tasks` advances the pinned rows with the JAX
    engine's host RNG and draw order, so its sequence is the JAX engine's.

`terminate_on_success` and `autoreset` take the JAX engine's meaning: a
success terminates the episode, and without autoreset no slot is ever
pending, so each step returns its own observation.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from metaworld_tpu_torch.envs.core import TaskSpec, env_reset, post_step
from metaworld_tpu_torch.physics import cuda_step, engine_lanes
from metaworld_tpu_torch.types import (
    MAX_PATH_LENGTH, EnvState, _Tree, tree_map)

OUT_KEYS = (
    "obs", "reward", "terminated", "truncated", "done", "episode_return",
    "episode_length", "success", "near_object", "grasp_success",
    "grasp_reward", "in_place_reward", "obj_to_target", "unscaled_reward",
)
_METRICS = ("success", "near_object", "grasp_success", "grasp_reward",
            "in_place_reward", "obj_to_target", "unscaled_reward")


def _select(mask, a, b):
    """Per-slot select between two batched trees (mask: (n,) bool)."""
    def sel(x, y):
        return torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y)

    return tree_map(sel, a, b)


@dataclasses.dataclass
class FusedState(_Tree):
    env: EnvState                # batched over the full batch
    pending_reset: torch.Tensor  # (n,) bool
    episode_return: torch.Tensor  # (n,) f32
    episode_length: torch.Tensor  # (n,) int32
    goal_idx: torch.Tensor       # (n,) int32 pinned goal rows (pseudorandom)


class FusedBatchedEnvs:
    """A fixed batch: `counts[i]` slots running `specs[i]`, physics for all
    slots in one step.

    `physics`: "cuda" (the hand-written kernel; CUDA device only), "torch"
    (the plain PyTorch lane engine, any device) or "auto" ("cuda" on a CUDA
    device, "torch" on the CPU). "auto" never moves tensors between devices.
    `goal_visible` is one flag for all tasks or one per task (the ML
    benchmarks hide the goal).
    """

    def __init__(
        self,
        specs: Sequence[TaskSpec],
        counts: Sequence[int],
        goal_tables: Sequence[np.ndarray],
        goal_visible: Sequence[bool] | bool = True,
        one_hot: bool = False,
        terminate_on_success: bool = False,
        max_episode_steps: int = MAX_PATH_LENGTH,
        autoreset: bool = True,
        task_select: str = "random",
        physics: str = "auto",
        device="cuda",
        seed: int = 0,
    ):
        assert len(specs) == len(counts) == len(goal_tables)
        assert task_select in ("random", "pseudorandom")
        assert physics in ("auto", "torch", "cuda")
        self.device = dev = torch.device(device)
        if physics == "auto":
            physics = "cuda" if dev.type == "cuda" else "torch"
        if physics == "cuda" and dev.type != "cuda":
            raise ValueError("physics='cuda' needs a CUDA device")
        self.physics = physics
        self.specs = list(specs)
        self.counts = [int(c) for c in counts]
        self.num_envs = int(sum(self.counts))
        if isinstance(goal_visible, bool):
            goal_visible = [goal_visible] * len(specs)
        self.goal_visible = [float(v) for v in goal_visible]
        self.terminate_on_success = bool(terminate_on_success)
        self.max_episode_steps = int(max_episode_steps)
        self.autoreset = bool(autoreset)
        self.task_select = task_select
        self._offsets = np.cumsum([0] + self.counts)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed)
        self._n_goals = [int(np.asarray(t).shape[0]) for t in goal_tables]
        # sample_tasks' host RNG and per-group cursors (JAX vector.py:97-99)
        self._prg_rng = np.random.default_rng(0)
        self._prg_perm = [None] * len(self.specs)
        self._prg_cursor = [None] * len(self.specs)

        slot_task = np.repeat(np.arange(len(specs)), self.counts)
        self.task_ids = torch.from_numpy(slot_task.astype(np.int32)).to(dev)

        # one-hot task id block
        self.one_hot = one_hot
        if one_hot:
            n = len(specs)
            oh = np.zeros((self.num_envs, n), dtype=np.float32)
            oh[np.arange(self.num_envs), slot_task] = 1.0
            self._one_hot_block = torch.from_numpy(oh).to(dev)
            self.obs_dim = 39 + n
        else:
            self._one_hot_block = None
            self.obs_dim = 39

        # physics: per-task scene table, the same-variant runs of blocks and
        # the block table of the kernel's one launch per step
        self.scene_table = cuda_step.build_scene_table(
            [s.scene for s in self.specs], dev)
        self.variant_runs = cuda_step.variant_runs(
            cuda_step.block_variants(self.scene_table.features[slot_task]),
            self.num_envs)
        self.block_table = cuda_step.block_table(
            slot_task, self.scene_table.features, device=dev)
        engine_lanes._reach_tables(dev)

        # reset table: one reset state + observation per (task, goal row)
        n_goals = self._n_goals
        goal_off = np.cumsum([0] + n_goals)[:-1]
        envs, obss = [], []
        for i, spec in enumerate(self.specs):
            table = torch.from_numpy(
                np.asarray(goal_tables[i], dtype=np.float32)).to(dev)
            st, obs = env_reset(spec, table, self.goal_visible[i], self._gen)
            envs.append(st)
            obss.append(obs)
        self._reset_env = tree_map(lambda *xs: torch.cat(xs), *envs)
        self._reset_obs = torch.cat(obss)
        self._slot_goal_off = torch.from_numpy(goal_off[slot_task]).to(dev)
        self._slot_goal_n = torch.from_numpy(
            np.asarray(n_goals)[slot_task].astype(np.float32)).to(dev)

    @property
    def task_names(self) -> list[str]:
        return [s.name for s in self.specs]

    def env_task_names(self) -> list[str]:
        """The task name of every slot, in slot order."""
        out = []
        for s, c in zip(self.specs, self.counts):
            out.extend([s.name] * c)
        return out

    def sample_tasks(self, state: FusedState) -> FusedState:
        """Advance every slot's pinned goal row: each slot cycles through its
        own shuffled permutation of its task's goal table and draws a new
        permutation when it wraps (JAX vector.py:178-206). Host bookkeeping
        with the JAX engine's RNG (`default_rng(0)` per engine) and draw
        order: per group, one permutation per slot at first use, then one
        per wrapping slot in slot order. Returns `state` with the new rows;
        they take effect at the next reset."""
        assert self.task_select == "pseudorandom"
        idx_groups = []
        for i, count in enumerate(self.counts):
            n_goals = self._n_goals[i]
            if self._prg_perm[i] is None:
                self._prg_perm[i] = np.stack([
                    self._prg_rng.permutation(n_goals) for _ in range(count)])
                self._prg_cursor[i] = np.zeros(count, dtype=np.int64)
            perm, cursor = self._prg_perm[i], self._prg_cursor[i]
            for j in np.flatnonzero(cursor >= n_goals):
                perm[j] = self._prg_rng.permutation(n_goals)
                cursor[j] = 0
            idx_groups.append(perm[np.arange(count), cursor].astype(np.int32))
            cursor += 1
        goal_idx = torch.from_numpy(np.concatenate(idx_groups)).to(self.device)
        return state.replace(goal_idx=goal_idx)

    # ------------------------------------------------------------------
    def _augment(self, obs):
        if self._one_hot_block is not None:
            return torch.cat([obs, self._one_hot_block], dim=1)
        return obs

    def _reset_rows(self, goal_idx):
        """Index into the reset table for every slot: the pinned goal row
        (pseudorandom) or a fresh uniform draw (random)."""
        if self.task_select == "pseudorandom":
            local = goal_idx.long()
        else:
            u = torch.rand(self.num_envs, generator=self._gen,
                           device=self.device)
            local = torch.minimum(torch.floor(u * self._slot_goal_n),
                                  self._slot_goal_n - 1.0).long()
        return self._slot_goal_off + local

    def reset(self, seed: int | None = None, vstate: FusedState | None = None,
              goal_idx=None):
        """Fresh reset of every slot. Returns (state, obs).

        `seed` reseeds the engine's generator (the JAX engine's `key`): the
        goal draws of task_select="random" come from it. `vstate` keeps that
        state's pinned goal rows (the JAX `reset(key, vstate=...)`), and
        `goal_idx` (n,) gives them directly; with neither, every slot is
        pinned to row 0. The pinned rows are used under
        task_select="pseudorandom"."""
        n = self.num_envs
        if seed is not None:
            self._gen.manual_seed(seed)
        if vstate is not None:
            assert goal_idx is None, "pass vstate or goal_idx, not both"
            goal_idx = vstate.goal_idx
        if goal_idx is None:
            goal_idx = torch.zeros(n, dtype=torch.int32, device=self.device)
        goal_idx = goal_idx.to(device=self.device, dtype=torch.int32)
        rows = self._reset_rows(goal_idx)
        env = tree_map(lambda t: t[rows], self._reset_env)
        state = FusedState(
            env=env,
            pending_reset=torch.zeros(n, dtype=torch.bool, device=self.device),
            episode_return=torch.zeros(n, device=self.device),
            episode_length=torch.zeros(n, dtype=torch.int32, device=self.device),
            goal_idx=goal_idx,
        )
        return state, self._augment(self._reset_obs[rows])

    def step(self, state: FusedState, actions):
        """One step of every slot. Returns (new_state, outputs) with the 14
        output keys of the JAX engine."""
        env = state.env
        if self.physics == "cuda":
            sim = cuda_step.control_step(self.scene_table, self.task_ids,
                                         env.sim, actions, self.block_table)
        else:
            sim = cuda_step.plain_control_step(self.scene_table, self.task_ids,
                                               env.sim, actions)
        # non-finite guard: unstable slots keep their last stable sim state
        n = self.num_envs
        stable = (torch.isfinite(sim.hand).all(-1)
                  & torch.isfinite(sim.obj_pos).reshape(n, -1).all(-1)
                  & torch.isfinite(sim.joint_q).all(-1)
                  & torch.isfinite(sim.gripper))
        sim = _select(stable, sim, env.sim)
        env = env.replace(sim=sim, path_length=env.path_length + 1)

        # per-task observation / reward tails
        prev, outs = [], []
        for i, spec in enumerate(self.specs):
            a, b = int(self._offsets[i]), int(self._offsets[i + 1])
            st_i = tree_map(lambda x: x[a:b], env)
            st2, out = post_step(spec, st_i, actions[a:b])
            prev.append(st2.prev_obs)
            outs.append(out)
        env = env.replace(prev_obs=torch.cat(prev))
        out = tree_map(lambda *xs: torch.cat(xs), *outs)
        reward = torch.where(stable, out.reward, 0.0)
        unscaled = torch.where(stable, out.unscaled_reward, 0.0)
        metrics = {k: getattr(out, k) for k in _METRICS}
        metrics["unscaled_reward"] = unscaled

        terminated = out.terminated
        if self.terminate_on_success:
            terminated = terminated | (out.success > 0)
        truncated = out.truncated | (env.path_length >= self.max_episode_steps)

        # NEXT_STEP autoreset: slots done last step return a fresh reset
        # and no step metrics
        pending = state.pending_reset
        obs = out.obs
        if self.autoreset:
            terminated = terminated & ~pending
            truncated = truncated & ~pending
            rows = self._reset_rows(state.goal_idx)
            env = _select(pending, tree_map(lambda t: t[rows], self._reset_env), env)
            obs = torch.where(pending[:, None], self._reset_obs[rows], obs)
            reward = torch.where(pending, 0.0, reward)
            metrics = {k: torch.where(pending, 0.0, v) for k, v in metrics.items()}

        done = terminated | truncated
        ep_ret = torch.where(pending, 0.0, state.episode_return) + reward
        ep_len = torch.where(pending, 0, state.episode_length) + 1
        new_state = FusedState(
            env=env,
            pending_reset=done if self.autoreset else torch.zeros_like(done),
            episode_return=ep_ret,
            episode_length=ep_len,
            goal_idx=state.goal_idx,
        )
        outputs = {
            "obs": self._augment(obs),
            "reward": reward,
            "terminated": terminated,
            "truncated": truncated,
            "done": done,
            "episode_return": ep_ret,
            "episode_length": ep_len,
            **metrics,
        }
        return new_state, outputs


def from_benchmark(bench, split: str = "train", envs_per_task: int = 1,
                   **kwargs) -> FusedBatchedEnvs:
    """`envs_per_task` slots per task of a benchmark's `split` ("train" or
    "test"), goals from that task's goal table of the split; the goal is
    hidden for tasks whose split is partially observable (the ML
    benchmarks). `kwargs` go to FusedBatchedEnvs."""
    assert split in ("train", "test")
    classes = bench.train_classes if split == "train" else bench.test_classes
    tasks = bench.train_tasks if split == "train" else bench.test_tasks
    names = list(classes.keys())
    visible = [not any(t.partially_observable for t in tasks if t.env_name == n)
               for n in names]
    return FusedBatchedEnvs(
        [classes[n] for n in names], [envs_per_task] * len(names),
        [bench.goal_table(n, split) for n in names], goal_visible=visible,
        **kwargs)
