"""The engine is differentiable end-to-end: finite jacobians, gradients
that match finite differences through multi-step unrolls, and a policy
trained purely by backprop through the physics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metaworld_tpu.envs import registry
from metaworld_tpu.envs.core import env_reset, env_step


def _state(name, vec):
    spec = registry.get_spec(name)
    rand = np.zeros(12)
    rand[: len(vec)] = vec
    st, _ = env_reset(spec, jnp.asarray(rand), jax.random.PRNGKey(0), 1.0)
    return spec, st


@pytest.mark.parametrize("name,vec", [
    ("reach-v3", [0.0, 0.65, 0.02, 0.0, 0.8, 0.2]),
    ("push-v3", [0.0, 0.65, 0.02, 0.05, 0.8, 0.02]),
    ("drawer-open-v3", [0.0, 0.9, 0.0]),
    ("hammer-v3", [0.05, 0.45, 0.0]),
])
def test_step_jacobian_finite(name, vec):
    """d(next sim state)/d(action) has no NaNs — padded zero-vector slots
    must not poison the backward pass (engine.py::_norm)."""
    spec, st = _state(name, vec)

    def step_sim(a):
        st2, _ = env_step(spec, st, a)
        return st2.sim

    # jit the pullback: the lane-oriented engine traces to thousands of
    # primitives, and an un-jitted jacrev dispatches every one eagerly per
    # output cotangent (minutes-to-hours); compiled it runs in seconds
    J = jax.jit(jax.jacrev(step_sim))(jnp.array([0.1, 0.05, -0.1, 0.3]))
    bad = [jax.tree_util.keystr(p)
           for p, leaf in jax.tree_util.tree_flatten_with_path(J)[0]
           if not bool(jnp.isfinite(leaf).all())]
    assert not bad, f"{name}: non-finite jacobian leaves {bad}"


@pytest.mark.slow
def test_unrolled_gradient_matches_finite_differences():
    """Slow (108 s in a whole tier-1 run): test_torch_differentiable.py::
    test_unrolled_gradient_matches_jax_and_finite_differences computes this
    same reach-v3 8-step gradient (`_jax_reach_grad`) in tier-1 and holds
    it to the same central differences."""
    spec, st = _state("reach-v3", [0.05, 0.62, 0.02, -0.06, 0.84, 0.24])

    @jax.jit
    def win(a):
        def body(c, _):
            s2, out = env_step(spec, c, a)
            return s2, out.reward
        _, rews = jax.lax.scan(body, st, None, length=8)
        return rews.sum()

    a0 = jnp.zeros(4)
    g = np.asarray(jax.jit(jax.grad(win))(a0))
    eps = 3e-3
    fd = np.array([
        (float(win(a0.at[i].add(eps))) - float(win(a0.at[i].add(-eps))))
        / (2 * eps) for i in range(4)])
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=2e-3)


@pytest.mark.slow
def test_apg_learns_reach():
    """Backprop-through-physics policy optimization reaches >=25% success on
    reach-v3 within 40 updates (scripts/train_apg.py converges to 100% in
    ~90; this is the smoke-sized version).

    Slow (220 s in a whole tier-1 run): test_torch_differentiable_apg.py::
    test_first_apg_update_gradient_matches_jax runs the JAX APG loss's
    gradient through the per-env engine in tier-1."""
    import optax
    from flax import linen as nn

    import metaworld_tpu as mw

    # fused=False: differentiation runs the per-env engine (engine.py) —
    # reverse-mode through the lane engine is a >15-min XLA:CPU compile
    envs = mw.vector.from_benchmark(mw.MT1("reach-v3", seed=0),
                                    envs_per_task=32, fused=False)
    H = 60

    class Pi(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = nn.tanh(nn.Dense(64)(nn.tanh(nn.Dense(64)(x))))
            return nn.tanh(nn.Dense(4)(h))

    model = Pi()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, envs.obs_dim)))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(3e-3))
    opt_state = tx.init(params)

    def episode(params, key):
        vstate, obs = envs.reset(key)

        def body(carry, _):
            vstate, obs = carry
            vstate, out = envs.step(vstate, model.apply(params, obs))
            return (vstate, out["obs"]), (out["reward"], out["success"])

        _, (rews, succ) = jax.lax.scan(body, (vstate, obs), None, length=H)
        w = jnp.linspace(0.3, 1.0, H)[:, None]
        return -(w * rews).mean(), succ.max(0).mean()

    @jax.jit
    def update(params, opt_state, key):
        key, sub = jax.random.split(key)
        (_, s), g = jax.value_and_grad(episode, has_aux=True)(params, sub)
        upd, opt_state = tx.update(g, opt_state)
        return optax.apply_updates(params, upd), opt_state, key, s

    key = jax.random.PRNGKey(1)
    best = 0.0
    for _ in range(40):
        params, opt_state, key, s = update(params, opt_state, key)
        best = max(best, float(s))
    assert best >= 0.25, f"APG only reached {best:.2f} success"
