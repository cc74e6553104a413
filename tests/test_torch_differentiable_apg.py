"""Analytic policy gradients on the port (`metaworld_tpu_torch.train_apg`)
against scripts/train_apg.py's JAX recipe.

The first update's gradient is held against JAX's with the same policy
weights (the flax `Pi` carried over by `convert.pi_from_flax`) within
rtol 1e-3 (ten steps of four envs and three dense layers; atol 1e-6 of a
leaf's largest entry for the entries that cancel to nothing). The `slow`
test trains reach-v3 to the JAX test's bar.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu import benchmarks as jbench
from metaworld_tpu import vector as jvector
from metaworld_tpu_torch import benchmarks, convert, train_apg, vector


def test_first_apg_update_gradient_matches_jax():
    """scripts/train_apg.py's loss at N = 4, H = 10 on reach-v3, each slot
    pinned to goal row i, with the flax policy's initial weights carried
    into train_apg.Pi: the parameter gradients agree."""
    from flax import linen as nn

    horizon, n, hidden = 10, 4, 32
    goal_idx = np.arange(n, dtype=np.int32)
    jenvs = jvector.from_benchmark(jbench.MT1("reach-v3", seed=0),
                                   envs_per_task=n, fused=False,
                                   task_select="pseudorandom")

    class Pi(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = x
            for _ in range(2):
                h = nn.tanh(nn.Dense(hidden)(h))
            return nn.tanh(nn.Dense(4)(h))

    model = Pi()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, jenvs.obs_dim)))

    def episode(params):
        vstate, obs = jenvs.reset(
            jax.random.PRNGKey(1),
            vstate=types.SimpleNamespace(goal_idx=jnp.asarray(goal_idx)))

        def body(carry, _):
            vstate, obs = carry
            vstate, out = jenvs.step(vstate, model.apply(params, obs))
            return (vstate, out["obs"]), out["reward"]

        _, rews = jax.lax.scan(body, (vstate, obs), None, length=horizon)
        w = jnp.linspace(0.3, 1.0, horizon)[:, None]
        return -(w * rews).mean()

    loss_j, grads_j = jax.jit(jax.value_and_grad(episode))(params)

    envs = vector.from_benchmark(benchmarks.MT1("reach-v3", seed=0),
                                 envs_per_task=n, fused=False, device="cpu",
                                 task_select="pseudorandom")
    pi = convert.pi_from_flax(jax.tree.map(np.asarray, params), "cpu")
    loss, _, _ = train_apg.episode_loss(pi, envs, horizon,
                                        goal_idx=torch.from_numpy(goal_idx))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for i, layer in enumerate(pi.layers):
        gj = grads_j["params"][f"Dense_{i}"]
        for got, ref in ((layer.weight.grad.numpy().T, np.asarray(gj["kernel"])),
                         (layer.bias.grad.numpy(), np.asarray(gj["bias"]))):
            assert np.abs(ref).max() > 0
            np.testing.assert_allclose(got, ref, rtol=1e-3,
                                       atol=1e-6 * np.abs(ref).max(),
                                       err_msg=f"Dense_{i}")


@pytest.mark.slow
def test_apg_learns_reach():
    """Backprop-through-physics policy optimisation reaches >= 25% success
    on reach-v3 within 40 updates (the JAX test's bar; 32 envs, H = 60,
    two tanh layers of 64, Adam 3e-3). About 45 minutes on one CPU core."""
    torch.manual_seed(0)
    envs = vector.from_benchmark(benchmarks.MT1("reach-v3", seed=0),
                                 envs_per_task=32, fused=False, device="cpu")
    pi = train_apg.Pi(envs.obs_dim, 64)
    opt = torch.optim.Adam(pi.parameters(), lr=3e-3)
    best = 0.0
    for _ in range(40):
        loss, _, s = train_apg.update(pi, opt, envs, 60)
        assert bool(torch.isfinite(loss))
        best = max(best, float(s))
    assert best >= 0.25, f"APG only reached {best:.2f} success"
