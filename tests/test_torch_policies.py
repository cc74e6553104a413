"""The port's 50 scripted experts, as functions, against the JAX package's.

For each task: the port's expert on the reference's own observations
(`tests/golden/<task>.npz`) under the rule of test_golden_parity.py (fewer
than 2% of steps off the recorded action by more than 1e-4), and against
the JAX expert (jit over vmap, as the JAX package runs it) on those 500
observations plus 256 perturbed copies made from a numpy seed: at least
99.5% of rows within 1e-5. `norm`, which decides the branch thresholds, is
held to within one float32 ulp of jnp.linalg.norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu.envs.registry import ALL_V3_ENVIRONMENTS
from metaworld_tpu.policies import get_policy as j_get_policy
from metaworld_tpu_torch.policies import base, get_policy, implemented_policies

N_PERTURBED = 256
POSITION_COLS = np.r_[0:3, 4:7, 11:14, 36:39]


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _perturbed(obs, seed):
    """N_PERTURBED copies of random rows of `obs` (n, 39) with the hand,
    object and goal positions moved by up to a few cm and a fresh gripper
    opening, so that rows fall on both sides of the experts' thresholds."""
    rng = np.random.default_rng(seed)
    out = obs[rng.integers(0, obs.shape[0], N_PERTURBED)].copy()
    out[:, POSITION_COLS] += rng.normal(0.0, 0.03, (N_PERTURBED, POSITION_COLS.size))
    out[:, 3] = rng.uniform(0.0, 1.0, N_PERTURBED)
    return out.astype(np.float32)


def test_all_fifty_experts_are_implemented():
    assert implemented_policies() == list(ALL_V3_ENVIRONMENTS)
    assert len(implemented_policies()) == 50


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("jit", [True, False], ids=["jit", "eager"])
def test_norm_within_one_ulp_of_xla(k, jit):
    rng = np.random.default_rng(k)
    scale = rng.choice([1e-3, 1e-2, 0.1, 1.0, 3.0], (20000, 1))
    x = (rng.standard_normal((20000, k)) * scale).astype(np.float32)
    ref_fn = jax.vmap(jnp.linalg.norm)
    ref = np.asarray(jax.jit(ref_fn)(x) if jit else ref_fn(x))
    got = base.norm(torch.from_numpy(x)).numpy()
    ulps = _ulps(got, ref)
    print(f"k={k} {'jit' if jit else 'eager'}: max {ulps.max()} ulp, "
          f"{int((ulps > 0).sum())} of {len(x)} rows differ")
    assert ulps.max() <= 1


@pytest.mark.parametrize("name", ALL_V3_ENVIRONMENTS)
def test_expert_golden_rule(name, golden):
    d = golden(name)
    obs = torch.from_numpy(d["obs"].astype(np.float32))
    ours = get_policy(name)(obs).numpy()
    assert ours.shape == d["action"].shape
    err = np.abs(ours - d["action"]).max(axis=1)
    frac_bad = float((err > 1e-4).mean())
    assert frac_bad < 0.02, f"{name}: {frac_bad:.1%} of steps mismatch (max {err.max():.4f})"


@pytest.mark.parametrize("name", ALL_V3_ENVIRONMENTS)
def test_expert_matches_jax(name, golden):
    gold = golden(name)["obs"].astype(np.float32)
    obs = np.concatenate([gold, _perturbed(gold, ALL_V3_ENVIRONMENTS.index(name))])
    ref = np.asarray(jax.jit(jax.vmap(j_get_policy(name)))(jnp.asarray(obs)))
    ours = get_policy(name)(torch.from_numpy(obs)).numpy()
    err = np.abs(ours - ref).max(axis=1)
    worst = int(np.argmax(err))
    print(f"{name}: worst row {worst} off by {err[worst]:.3e}; "
          f"{int((err > 1e-5).sum())} of {len(obs)} rows above 1e-5")
    assert float((err <= 1e-5).mean()) >= 0.995


def test_select_takes_the_first_true_case():
    cond_a = torch.tensor([True, False, False, True])
    cond_b = torch.tensor([True, True, False, False])
    rows = torch.arange(12.0).reshape(4, 3)
    got = base.select((cond_a, rows), (cond_b, -rows), default=torch.zeros(4, 3))
    want = torch.stack([rows[0], -rows[1], torch.zeros(3), rows[3]])
    assert torch.equal(got, want)
    lanes = base.select((cond_a, 1.0), (cond_b, 2.0), default=3.0)
    assert lanes.tolist() == [1.0, 2.0, 3.0, 1.0]


def test_constants_are_made_once_per_device():
    obs = torch.zeros(3, 39)
    for name in ALL_V3_ENVIRONMENTS:
        get_policy(name)(obs)
    made = dict(base._CONSTS)
    for name in ALL_V3_ENVIRONMENTS:
        get_policy(name)(obs + 0.1)
    assert len(base._CONSTS) == len(made)
    assert all(base._CONSTS[k] is t for k, t in made.items())
    assert base.const(obs, 0.1, 0.2, 0.3).shape == (1, 3)
