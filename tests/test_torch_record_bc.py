"""The offline-data loop of the port: `record_dataset` into the native store
and a behaviour-cloning epoch of `train_bc`, against the JAX recipes.

* `record_dataset.record` on MT1 reach-v3 (2 envs, 5 steps, the plain
  physics) writes one record per step whose arrays equal, bit for bit, the
  same engine stepped by hand, and the JAX package's reader reads them;
  `train_bc.record_expert` stores the effective action (xyz clipped to
  [-1, 1]).
* One BC epoch (`train_bc.bc_epoch`) from the flax `Pi`'s initial weights
  (`convert.bc_pi_from_flax`, 256 hidden units) over the same permutation
  leaves the parameters of scripts/train_bc.py's optax epoch (rewritten
  here from its `main()`): rtol 1e-5, atol 1e-7 for the biases that start
  at zero. Adam divides each entry's step by the root of its own squared
  gradient plus 1e-8, so an entry whose first gradient is below 1e-6 (about
  6e-5 of the largest, for one entry in 10^4 here) takes a step set by the
  float32 rounding of a near-zero gradient sum, which the two frameworks
  order differently (-1.25e-8 in JAX for the one entry that shows it):
  those entries are held at 2e-5 absolute, 2% of one step at lr 1e-3.
* (`-m slow`, about 5 min) scripts/train_bc.py's seed-0 init, carried
  over, trained by the port on the port's own recording at the script's
  defaults, succeeds in closed loop as it does in JAX (1.0 there): the
  port's data and engine are not what decides the default seed's result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from metaworld_tpu import native as jnative
from metaworld_tpu_torch import (benchmarks, convert, native, record_dataset,
                                 train_bc, vector)
from metaworld_tpu_torch.evaluation import ScriptedAgent
from metaworld_tpu_torch.policies import get_policy

KEYS = ["action", "done", "obs", "reward", "success"]


class Pi(nn.Module):  # scripts/train_bc.py's policy
    @nn.compact
    def __call__(self, x):
        h = nn.tanh(nn.Dense(256)(nn.tanh(nn.Dense(256)(x))))
        return nn.tanh(nn.Dense(4)(h))


def test_record_writes_the_engines_steps(tmp_path):
    envs = record_dataset.make_envs(["reach-v3"], 2, "cpu")
    agent = ScriptedAgent(envs)
    path = tmp_path / "d.ts"
    with native.TrajectoryWriter(str(path)) as w:
        record_dataset.record(envs, agent, w, episodes=1, steps=5, seed=3)
        stats = w.stats()
    assert stats["pushed"] == 5 and stats["dropped"] == 0
    assert record_dataset.replay(str(path)) == (5, 10, KEYS)
    recs = list(native.TrajectoryReader(str(path)))
    for a, b in zip(recs, jnative.TrajectoryReader(str(path))):
        for k in KEYS:
            np.testing.assert_array_equal(a[k], b[k])
    state, obs = envs.reset(seed=3)
    for rec in recs:
        acts = agent.eval_action(obs)
        state, out = envs.step(state, acts)
        for k, v in (("obs", obs), ("action", acts), ("reward", out["reward"]),
                     ("done", out["done"]), ("success", out["success"])):
            assert rec[k].dtype == v.numpy().dtype, k
            np.testing.assert_array_equal(rec[k], v.numpy(), err_msg=k)
        obs = out["obs"]


def test_record_expert_clips_the_xyz_action(tmp_path):
    envs = record_dataset.make_envs(["reach-v3"], 2, "cpu")

    def loud(obs):  # an expert with heavy-tailed xyz
        return torch.tensor([[5.0, -3.0, 0.5, 2.0]]).expand(obs.shape[0], 4)

    path = tmp_path / "bc.ts"
    with native.TrajectoryWriter(str(path)) as w:
        train_bc.record_expert(envs, loud, w, steps=2, seed=0)
    X, Y = train_bc.load(str(path), "cpu")
    assert tuple(X.shape) == (4, 39)
    assert Y.tolist() == [[1.0, -1.0, 0.5, 2.0]] * 4


def test_bc_epoch_matches_optax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1100, 39)).astype(np.float32)  # two minibatches
    Y = rng.uniform(-1, 1, (1100, 4)).astype(np.float32)
    perm = rng.permutation(1100)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    model = Pi()
    params = model.init(jax.random.PRNGKey(0), X[:1])
    tx = optax.adam(1e-3)

    @jax.jit
    def epoch(params, opt_state):
        def mb(carry, idx):
            params, opt_state = carry

            def loss_fn(p):
                return jnp.mean(jnp.square(model.apply(p, Xj[idx]) - Yj[idx]))

            loss, g = jax.value_and_grad(loss_fn)(params)
            upd, opt_state = tx.update(g, opt_state)
            return (optax.apply_updates(params, upd), opt_state), loss

        nb = X.shape[0] // 512
        idxs = perm[: nb * 512].reshape(nb, 512)
        (params, opt_state), losses = jax.lax.scan(mb, (params, opt_state), idxs)
        return params, losses.mean()

    params_j, loss_j = epoch(params, tx.init(params))
    g0 = jax.grad(lambda p: jnp.mean(jnp.square(
        model.apply(p, Xj[perm[:512]]) - Yj[perm[:512]])))(params)["params"]
    pi = convert.bc_pi_from_flax(jax.tree.map(np.asarray, params), "cpu")
    opt = torch.optim.Adam(pi.parameters(), lr=1e-3)
    loss = train_bc.bc_epoch(pi, opt, torch.from_numpy(X), torch.from_numpy(Y),
                             torch.from_numpy(perm))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for i, layer in zip((1, 0, 2), pi.layers):
        ref = params_j["params"][f"Dense_{i}"]
        g = g0[f"Dense_{i}"]
        for got, want, grad in (
                (layer.weight.detach().numpy().T, ref["kernel"], g["kernel"]),
                (layer.bias.detach().numpy(), ref["bias"], g["bias"])):
            want, noisy = np.asarray(want), np.abs(np.asarray(grad)) < 1e-6
            assert noisy.mean() < 0.01
            np.testing.assert_allclose(got[~noisy], want[~noisy], rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(got[noisy], want[noisy], rtol=0, atol=2e-5)


@pytest.mark.slow
def test_bc_from_the_jax_init_on_the_ports_data(tmp_path):
    env, seed = "drawer-open-v3", 0  # scripts/train_bc.py's defaults
    envs = vector.from_benchmark(benchmarks.MT1(env, seed=seed),
                                 envs_per_task=16, device="cpu")
    path = str(tmp_path / "bc.ts")
    with native.TrajectoryWriter(path) as w:
        train_bc.record_expert(envs, get_policy(env), w, train_bc.EPISODE_STEPS, seed)
    X, Y = train_bc.load(path, "cpu")
    params = Pi().init(jax.random.PRNGKey(seed), jnp.asarray(X[:1].numpy()))
    pi = convert.bc_pi_from_flax(jax.tree.map(np.asarray, params), "cpu")
    losses = train_bc.fit(pi, X, Y, 60, 1e-3, seed + 1)
    succ = float(train_bc.evaluate(pi, envs, seed + 100))
    print(f"JAX seed-{seed} init, the port's data: loss {float(losses[0]):.5f} -> "
          f"{float(losses[-1]):.5f}, bc_success_rate {succ}")
    assert succ >= 0.9
