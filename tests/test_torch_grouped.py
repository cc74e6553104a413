"""The port's `vector.BatchedEnvs` (the JAX package's grouped engine, here
the fused engine over the plain, differentiable physics) against the JAX
`BatchedEnvs` on MT10, with the one-hot block numbered within MT50
(`num_tasks=50`, `task_indices`), pinned goal rows and 3-step episodes so
that NEXT_STEP autoreset is crossed. Each step the port restarts from the
JAX state (the groups concatenated). Tolerances: reset observations 1e-6
(test_torch_env.py); step observations, rewards and metrics 1e-4, episode
returns 1e-4 (test_torch_env_step_a.py); flags, lengths and the one-hot
block exact. Also: the outputs keep autograd history from the actions to
the rewards and observations, across autoresets.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu import vector as jvector
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch import convert, vector
from metaworld_tpu_torch.vector import FusedState

PER_TASK = 2
N_GOALS = 5
STEPS = 5
EXACT = ("terminated", "truncated", "done", "episode_length")


@functools.lru_cache(maxsize=None)
def _engines():
    names = jbench.MT10_LIST
    idx = [jbench.MT50_LIST.index(n) for n in names]
    kw = dict(one_hot=True, num_tasks=50, task_indices=idx,
              max_episode_steps=3, task_select="pseudorandom")
    jb = jbench.MT10(seed=0, num_goals=N_GOALS)
    tb = tbench.MT10(seed=0, num_goals=N_GOALS)
    je = jvector.BatchedEnvs([jb.train_classes[n] for n in names],
                             [PER_TASK] * 10, [jb.goal_table(n) for n in names], **kw)
    te = vector.from_benchmark(tb, envs_per_task=PER_TASK, fused=False,
                               device="cpu", **kw)
    return je, te


def _port_state(vstate) -> FusedState:
    """The JAX grouped state as the port's fused state."""
    g = jax.tree.map(lambda *x: jnp.concatenate(x), *vstate.groups)
    return convert.fused_from_dict(convert.as_dict(g), "cpu")


def test_grouped_engine_matches_jax():
    je, te = _engines()
    assert isinstance(te, vector.BatchedEnvs) and te.physics == "torch"
    assert te.obs_dim == je.obs_dim == 89
    goal_idx = np.arange(te.num_envs, dtype=np.int32) % N_GOALS
    vstate, obs_j = je.reset(jax.random.PRNGKey(0),
                             vstate=types.SimpleNamespace(goal_idx=jnp.asarray(goal_idx)))
    _, obs_t = te.reset(goal_idx=torch.from_numpy(goal_idx))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(obs_t[:, 39:].numpy(), np.asarray(obs_j)[:, 39:])
    rng = np.random.default_rng(0)
    crossed = False
    for t in range(STEPS):
        act = rng.uniform(-1, 1, (te.num_envs, 4)).astype(np.float32)
        new_j, out_j = je.step(vstate, jnp.asarray(act))
        _, out_t = te.step(_port_state(vstate), torch.from_numpy(act))
        assert set(out_t) == set(out_j)
        for k, v in out_j.items():
            ref, got = np.asarray(v), out_t[k].numpy()
            if k in EXACT:
                np.testing.assert_array_equal(got, ref, err_msg=f"t={t} {k}")
            else:
                np.testing.assert_allclose(got.astype(np.float64), ref, rtol=0,
                                           atol=1e-4, err_msg=f"t={t} {k}")
        crossed |= bool(np.asarray(out_j["episode_length"] == 1).any() and t > 0)
        vstate = new_j
    assert crossed  # an autoreset happened inside the window


def test_outputs_keep_autograd_history_across_autoreset():
    """Rewards and observations are differentiable in the actions through
    the plain physics; the autoreset step (step 4 of 3-step episodes, which
    ignores its action) returns reset observations with zero gradient, and
    the next episode's rewards are differentiable again."""
    _, te = _engines()
    state, _ = te.reset(goal_idx=torch.zeros(te.num_envs, dtype=torch.int32))
    acts = [torch.full((te.num_envs, 4), 0.3, requires_grad=True) for _ in range(5)]
    outs = []
    for a in acts:
        state, out = te.step(state, a)
        assert out["reward"].requires_grad and out["obs"].requires_grad
        outs.append(out)
    assert outs[3]["episode_length"].eq(1).all()  # every slot reset at step 4

    def grads(y, xs):
        return [torch.zeros_like(x) if g is None else g for x, g in zip(
            xs, torch.autograd.grad(y.sum(), xs, retain_graph=True,
                                    allow_unused=True))]

    (g,) = grads(outs[1]["reward"], acts[:1])
    assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
    assert all(bool((x == 0).all()) for x in grads(outs[3]["obs"], acts))
    (g,) = grads(outs[4]["reward"], acts[4:])
    assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
