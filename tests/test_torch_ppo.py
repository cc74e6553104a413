"""PPO on the port (`metaworld_tpu_torch.train_ppo`) against the JAX recipe
of scripts/train_ppo.py, rewritten here from the script's `main()`:

* `gae` equals the recipe's `lax.scan` on random rewards, values and dones
  (rtol 1e-6);
* `ppo_loss` and its gradients, with the flax `ActorCritic`'s initial
  weights carried over by `convert.actor_critic_from_flax`, equal JAX's
  (loss rtol 1e-5; gradients rtol 1e-4 and atol 1e-6 of a leaf's largest
  entry, for the entries that cancel to nothing);
* three optimizer steps (gradient clip to a global norm of 0.5, Adam on
  optax's cosine schedule, decayed to its floor at the third step) leave
  the same parameters as optax's chain (rtol 1e-5, atol 1e-7 for entries
  that start at zero);
* one `update` on MT1 reach-v3 at N = 4, rollout 4, on the CPU gives finite
  statistics;
* (`-m slow`, about 12 min) reach-v3 at the script's defaults for 40
  updates: the PPO loss on each update's batch falls across the learner in
  all but a tenth of the updates, the rule chip_smoke.py holds the card
  to (on one rollout step's slice the loss rises more often).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from metaworld_tpu_torch import convert, train_ppo

OBS_DIM, HIDDEN, BATCH = 12, 16, 64
GAMMA, LAM, CLIP = 0.99, 0.95, 0.2


class ActorCritic(nn.Module):
    """scripts/train_ppo.py's flax model, at a small width."""

    @nn.compact
    def __call__(self, x):
        ha = x
        for _ in range(2):
            ha = nn.tanh(nn.Dense(HIDDEN)(ha))
        mean = nn.tanh(nn.Dense(4)(ha))
        log_std = jnp.clip(
            self.param("log_std", nn.initializers.constant(-0.5), (4,)),
            -3.0, 0.5)
        hv = x
        for _ in range(2):
            hv = nn.tanh(nn.Dense(HIDDEN)(hv))
        value = nn.Dense(1)(hv)[..., 0]
        return mean, log_std, value


MODEL = ActorCritic()


def jax_ppo_loss(params, batch):
    obs, act, old_logp, adv, ret = batch
    mean, log_std, value = MODEL.apply(params, obs)
    std = jnp.exp(log_std)
    logp = (-0.5 * (((act - mean) / std) ** 2 + 2 * log_std
                    + jnp.log(2 * jnp.pi))).sum(-1)
    ratio = jnp.exp(logp - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg = -jnp.minimum(ratio * adv_n,
                      jnp.clip(ratio, 1 - CLIP, 1 + CLIP) * adv_n).mean()
    vloss = jnp.square(value - ret).mean()
    ent = (log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e)).sum()
    return pg + 0.5 * vloss - 5e-3 * ent


def jax_gae(rewards, values, dones, last_value):
    T = rewards.shape[0]

    def body(adv, t):
        nv = jnp.where(t == T - 1, last_value, values_pad[t + 1])
        delta = rewards[t] + GAMMA * nv * (1 - dones[t]) - values[t]
        adv = delta + GAMMA * LAM * (1 - dones[t]) * adv
        return adv, adv

    values_pad = jnp.concatenate([values, last_value[None]], axis=0)
    _, advs = jax.lax.scan(body, jnp.zeros_like(last_value),
                           jnp.arange(T)[::-1])
    advs = advs[::-1]
    return advs, advs + values


@pytest.fixture(scope="module")
def setup():
    params = MODEL.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS_DIM)))
    # a log_std off its init, so its gradient and update are non-trivial
    params = jax.tree.map(np.asarray, params)
    params["params"]["log_std"] = np.array([-0.5, -0.2, -0.8, 0.1], np.float32)
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(BATCH, OBS_DIM)).astype(np.float32)
    mean, log_std, _ = MODEL.apply(params, obs)
    act = np.clip(np.asarray(mean) + np.exp(np.asarray(log_std))
                  * rng.normal(size=(BATCH, 4)), -1, 1).astype(np.float32)
    batch = (obs, act, rng.normal(-3, 1, BATCH).astype(np.float32),
             rng.normal(0, 2, BATCH).astype(np.float32),
             rng.normal(5, 3, BATCH).astype(np.float32))
    return params, batch


def _leaves(model):
    """(name, torch tensor as the flax leaf's layout, flax path) pairs."""
    layers = [*model.actor, model.mean, *model.critic, model.value]
    for i, layer in enumerate(layers):
        yield f"Dense_{i}", "kernel", layer.weight, lambda t: t.T
        yield f"Dense_{i}", "bias", layer.bias, lambda t: t
    yield "log_std", None, model.log_std, lambda t: t


def _flax(tree, dense, leaf):
    p = tree["params"][dense]
    return np.asarray(p if leaf is None else p[leaf])


def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    T, n = 9, 7
    rew = rng.uniform(0, 10, (T, n)).astype(np.float32)
    val = rng.normal(20, 5, (T, n)).astype(np.float32)
    done = (rng.uniform(size=(T, n)) < 0.2).astype(np.float32)
    last = rng.normal(20, 5, n).astype(np.float32)
    adv_j, ret_j = jax.jit(jax_gae)(rew, val, done, last)
    adv, ret = train_ppo.gae(*(torch.from_numpy(x) for x in (rew, val, done, last)),
                             GAMMA, LAM)
    np.testing.assert_allclose(adv.numpy(), np.asarray(adv_j), rtol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(ret_j), rtol=1e-6)


def test_ppo_loss_and_gradients_match_jax(setup):
    params, batch = setup
    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_ppo_loss))(params, batch)
    model = convert.actor_critic_from_flax(params, "cpu")
    loss = train_ppo.ppo_loss(model, [torch.from_numpy(x) for x in batch], CLIP)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for dense, leaf, p, to_flax in _leaves(model):
        ref = _flax(grads_j, dense, leaf)
        assert np.abs(ref).max() > 0, dense
        np.testing.assert_allclose(to_flax(p.grad).numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=f"{dense} {leaf}")


def test_optimizer_steps_match_optax(setup):
    params, batch = setup
    lr, total = 3e-3, 2
    sched = optax.cosine_decay_schedule(lr, total, alpha=0.1)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(sched))
    opt_state = tx.init(params)
    model = convert.actor_critic_from_flax(params, "cpu")
    opt, lr_sched = train_ppo.make_optimizer(model, lr, total)
    tb = [torch.from_numpy(x) for x in batch]
    grad_fn = jax.jit(jax.grad(jax_ppo_loss))
    p = params
    for _ in range(3):
        upd, opt_state = tx.update(grad_fn(p, batch), opt_state)
        p = optax.apply_updates(p, upd)
        train_ppo.optimizer_step(model, opt, lr_sched,
                                 train_ppo.ppo_loss(model, tb, CLIP))
    assert opt.param_groups[0]["lr"] == pytest.approx(float(sched(3)))
    for dense, leaf, t, to_flax in _leaves(model):
        np.testing.assert_allclose(to_flax(t.detach()).numpy(),
                                   _flax(p, dense, leaf), rtol=1e-5, atol=1e-7,
                                   err_msg=f"{dense} {leaf}")


def test_one_update_on_reach_is_finite():
    args = train_ppo.parse_args(["--env", "reach-v3", "--envs-per-task", "4",
                                 "--rollout", "4", "--updates", "1",
                                 "--epochs", "2", "--minibatches", "2",
                                 "--device", "cpu"])
    envs, model, opt, sched, gen = train_ppo.setup(args)
    before = [p.detach().clone() for p in model.parameters()]
    vstate, obs = envs.reset(seed=0)
    vstate, obs, stats = train_ppo.update(model, opt, sched, envs, vstate, obs,
                                          gen, args)
    assert set(stats) == {"loss", "mean_reward", "success_rate"}
    assert all(torch.isfinite(v) for v in stats.values())
    assert 0 <= float(stats["success_rate"]) <= 1
    assert tuple(obs.shape) == (4, 39)
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


@pytest.mark.slow
def test_reach_learner_lowers_its_batch_loss():
    args = train_ppo.parse_args(["--env", "reach-v3", "--updates", "40",
                                 "--device", "cpu"])
    envs, model, opt, sched, gen = train_ppo.setup(args)
    vstate, obs = envs.reset(seed=args.seed)
    rose = {"batch": [], "first step": []}
    for i in range(args.updates):
        vstate, obs, traj, last = train_ppo.rollout(model, envs, vstate, obs,
                                                    args.rollout, gen)
        adv, ret = train_ppo.gae(traj["reward"], traj["value"], traj["done"],
                                 last, args.gamma, args.lam)
        parts = (traj["obs"], traj["act"], traj["logp"], adv, ret)
        probes = {"batch": [x.reshape((-1,) + x.shape[2:]) for x in parts],
                  "first step": [x[0] for x in parts]}
        with torch.no_grad():
            before = {k: float(train_ppo.ppo_loss(model, b, args.clip))
                      for k, b in probes.items()}
        train_ppo.learn(model, opt, sched, traj, adv, ret, args.epochs,
                        args.minibatches, args.clip, gen)
        with torch.no_grad():
            for k, b in probes.items():
                after = float(train_ppo.ppo_loss(model, b, args.clip))
                if not after < before[k]:
                    rose[k].append((i, before[k], after))
    print(f"the loss rose across the learner in {rose}")
    assert len(rose["batch"]) <= args.updates // 10
