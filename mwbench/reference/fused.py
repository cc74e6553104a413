"""The fused multi-task step in plain form: one control step of every env
of a task-set layout, in the order `vector.FusedBatchedEnvs.step` runs its
layers: the weld target and five substeps of the plain lane engine, the
non-finite guard, each task's observation and reward tail, and NEXT_STEP
autoreset from a reset table this module builds for itself.

The program draws each pending slot's goal row on the device. The reference
is handed those rows (`match_rows` finds them from the program's reset
states, which must equal a row of the slot's own goal table) and rebuilds
the reset states from its own goal tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mwbench.reference import benchmarks
from mwbench.reference.envs import registry
from mwbench.reference.envs.core import env_reset, keep_stable, post_step, select_slots
from mwbench.reference.physics import plain_step
from mwbench.reference.types import MAX_PATH_LENGTH, EnvState, SimState, tree_map

METRICS = ("success", "near_object", "grasp_success", "grasp_reward",
           "in_place_reward", "obj_to_target", "unscaled_reward")


@dataclasses.dataclass
class FusedState:
    env: EnvState
    pending_reset: torch.Tensor   # (n,) bool
    episode_return: torch.Tensor  # (n,) f32
    episode_length: torch.Tensor  # (n,) int32
    goal_idx: torch.Tensor        # (n,) int32


def task_counts(n_envs: int, n_tasks: int) -> list[int]:
    base, rem = divmod(n_envs, n_tasks)
    return [base + (1 if i < rem else 0) for i in range(n_tasks)]


def state_from_tree(tree: dict) -> FusedState:
    """A FusedState from nested dicts of tensors keyed by field name."""
    env = dict(tree["env"])
    env["sim"] = SimState(**env["sim"])
    return FusedState(**{**tree, "env": EnvState(**env)})


class Layout:
    """The task set `benchmark` (a name in `benchmarks`, its train split)
    with its goal tables made from `seed`, `n_envs` slots split evenly over
    its tasks, the goal visible and a one-hot task block."""

    def __init__(self, benchmark: str, n_envs: int, seed: int, device,
                 max_episode_steps: int = MAX_PATH_LENGTH, **bench_kw):
        self.device = dev = torch.device(device)
        bench = getattr(benchmarks, benchmark)(seed=seed, **bench_kw)
        self.names = list(bench.train_classes)
        self.specs = [registry.get_spec(n) for n in self.names]
        self.counts = task_counts(n_envs, len(self.names))
        self.n = n_envs
        self.offsets = np.cumsum([0] + self.counts)
        self.max_episode_steps = max_episode_steps
        slot_task = np.repeat(np.arange(len(self.names)), self.counts)
        self.task_ids = torch.from_numpy(slot_task).to(dev)
        self.scene_table = plain_step.build_scene_table(
            [s.scene for s in self.specs], dev)
        oh = np.zeros((n_envs, len(self.names)), np.float32)
        oh[np.arange(n_envs), slot_task] = 1.0
        self.one_hot = torch.from_numpy(oh).to(dev)
        self.goal_tables = [torch.from_numpy(np.asarray(
            bench.goal_table(n), np.float32)).to(dev) for n in self.names]
        n_goals = [t.shape[0] for t in self.goal_tables]
        self.goal_off = np.cumsum([0] + n_goals)[:-1]
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        envs, obss = [], []
        for spec, table in zip(self.specs, self.goal_tables):
            st, obs = env_reset(spec, table, 1.0, gen)
            envs.append(st)
            obss.append(obs)
        self.reset_env = tree_map(lambda *xs: torch.cat(xs), *envs)
        self.reset_obs = torch.cat(obss)

    def match_rows(self, rand_vec, mask):
        """(rows into the reset table (n,), number of masked slots whose
        task vector is no row of their own task's goal table). Slots outside
        `mask` get row 0 of their task."""
        rows = torch.zeros(self.n, dtype=torch.long, device=self.device)
        unmatched = 0
        for i, table in enumerate(self.goal_tables):
            a, b = int(self.offsets[i]), int(self.offsets[i + 1])
            m = mask[a:b]
            eq = (rand_vec[a:b, None, :] == table[None]).all(-1)
            hit = eq.any(-1)
            unmatched += int((m & ~hit).sum())
            rows[a:b] = int(self.goal_off[i]) + eq.to(torch.int8).argmax(-1)
        return rows, unmatched

    def reset_state(self, rows):
        """(state, obs) of a fresh reset onto reset-table `rows`."""
        n, dev = self.n, self.device
        env = tree_map(lambda t: t[rows], self.reset_env)
        st = FusedState(env=env,
                        pending_reset=torch.zeros(n, dtype=torch.bool, device=dev),
                        episode_return=torch.zeros(n, device=dev),
                        episode_length=torch.zeros(n, dtype=torch.int32, device=dev),
                        goal_idx=torch.zeros(n, dtype=torch.int32, device=dev))
        return st, torch.cat([self.reset_obs[rows], self.one_hot], dim=1)

    def step(self, st: FusedState, actions, rows):
        """One step of every slot; `rows` (n,) are the reset-table rows of
        the pending slots. Returns (state, outputs)."""
        env, act = st.env, actions
        sim = plain_step.plain_control_step(self.scene_table, self.task_ids,
                                            env.sim, act)
        sim, stable = keep_stable(sim, env.sim)
        env = dataclasses.replace(env, sim=sim, path_length=env.path_length + 1)
        prev, outs = [], []
        for i, spec in enumerate(self.specs):
            a, b = int(self.offsets[i]), int(self.offsets[i + 1])
            if a >= b:
                continue
            st_i = tree_map(lambda x: x[a:b], env)
            st2, out = post_step(spec, st_i, act[a:b])
            prev.append(st2.prev_obs)
            outs.append(out)
        env = dataclasses.replace(env, prev_obs=torch.cat(prev))
        out = tree_map(lambda *xs: torch.cat(xs), *outs)
        reward = torch.where(stable, out.reward, 0.0)
        metrics = {k: getattr(out, k) for k in METRICS}
        metrics["unscaled_reward"] = torch.where(stable, out.unscaled_reward, 0.0)
        pending = st.pending_reset
        terminated = out.terminated & ~pending
        truncated = (out.truncated | (env.path_length >= self.max_episode_steps)) & ~pending
        env = select_slots(pending, tree_map(lambda t: t[rows], self.reset_env), env)
        obs = torch.where(pending[:, None], self.reset_obs[rows], out.obs)
        reward = torch.where(pending, 0.0, reward)
        metrics = {k: torch.where(pending, 0.0, v) for k, v in metrics.items()}
        done = terminated | truncated
        ep_ret = torch.where(pending, 0.0, st.episode_return) + reward
        ep_len = torch.where(pending, 0, st.episode_length) + 1
        new = FusedState(env=env, pending_reset=done, episode_return=ep_ret,
                         episode_length=ep_len, goal_idx=st.goal_idx)
        outputs = {"obs": torch.cat([obs, self.one_hot], dim=1),
                   "reward": reward, "terminated": terminated,
                   "truncated": truncated, "done": done,
                   "episode_return": ep_ret, "episode_length": ep_len, **metrics}
        return new, outputs
