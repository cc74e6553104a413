"""Backprop through the port's plain physics (the counterpart of
tests/test_differentiable.py): finite jacobians, an unrolled gradient
against `jax.grad` through the JAX package's per-env engine and against
central differences, and the CUDA kernel's refusal to run under autograd.
test_torch_differentiable_apg.py holds the policy-gradient cases.

Tolerances: the reach gradient within rtol 1e-4 of JAX's (both engines
compute the same function in float32), and within the JAX test's
tolerance of central differences (rtol 2e-2, atol 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaworld_tpu.envs import registry as jreg
from metaworld_tpu.envs.core import env_reset as j_env_reset
from metaworld_tpu.envs.core import env_step as j_env_step
from metaworld_tpu_torch.envs import core as tcore
from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.physics import cuda_step
from metaworld_tpu_torch.types import MAX_RAND, SimState


def _state(name, vec):
    rand = np.zeros((1, MAX_RAND), np.float32)
    rand[0, : len(vec)] = vec
    spec = registry.get_spec(name)
    st, _ = tcore.env_reset(spec, torch.from_numpy(rand), 1.0)
    return spec, st


@pytest.mark.parametrize("name,vec", [
    ("reach-v3", [0.0, 0.65, 0.02, 0.0, 0.8, 0.2]),
    ("push-v3", [0.0, 0.65, 0.02, 0.05, 0.8, 0.02]),
    ("drawer-open-v3", [0.0, 0.9, 0.0]),
    ("hammer-v3", [0.05, 0.45, 0.0]),
])
def test_step_jacobian_finite(name, vec):
    """d(next sim state)/d(action) has no NaN or infinity: no unselected
    branch of the lane engine poisons the backward pass."""
    spec, st = _state(name, vec)
    fields = list(SimState.__dataclass_fields__)

    def step_sim(a):
        st2, _ = tcore.env_step(spec, st, a[None], physics="torch")
        return tuple(getattr(st2.sim, f).float() for f in fields)

    # vectorize: one batched backward pass over the output cotangents
    jac = torch.autograd.functional.jacobian(
        step_sim, torch.tensor([0.1, 0.05, -0.1, 0.3]), vectorize=True)
    bad = [f for f, j in zip(fields, jac) if not bool(torch.isfinite(j).all())]
    assert not bad, f"{name}: non-finite jacobian of {bad}"
    hand = jac[fields.index("hand")]
    assert float(hand.abs().sum()) > 0  # the action moves the hand


REACH_VEC = [0.05, 0.62, 0.02, -0.06, 0.84, 0.24]


def _reach_windows(acts):
    """Reward summed over 8 steps of each slot's held action, acts (k, 4):
    k slots of reach-v3 from the same reset state (the slots are
    independent, so one batch holds the window and its central
    differences)."""
    spec, st = _state("reach-v3", REACH_VEC)
    st = st.map(lambda x: x.expand((acts.shape[0],) + x.shape[1:]).clone())
    total = 0.0
    for _ in range(8):
        st, out = tcore.env_step(spec, st, acts, physics="torch")
        total = total + out.reward
    return total


def _jax_reach_grad():
    spec = jreg.get_spec("reach-v3")
    rand = np.zeros(12)
    rand[: len(REACH_VEC)] = REACH_VEC
    st, _ = j_env_reset(spec, jnp.asarray(rand), jax.random.PRNGKey(0), 1.0)

    def win(a):
        def body(c, _):
            s2, out = j_env_step(spec, c, a)
            return s2, out.reward
        _, rews = jax.lax.scan(body, st, None, length=8)
        return rews.sum()

    return np.asarray(jax.jit(jax.grad(win))(jnp.zeros(4)))


def test_unrolled_gradient_matches_jax_and_finite_differences():
    a0 = torch.zeros(4, requires_grad=True)
    eps = 3e-3
    shifts = torch.cat([torch.zeros(1, 4), eps * torch.eye(4), -eps * torch.eye(4)])
    windows = _reach_windows(torch.cat([a0[None], a0.detach() + shifts[1:]]))
    windows[0].backward()
    g = a0.grad.numpy()
    np.testing.assert_allclose(g, _jax_reach_grad(), rtol=1e-4, atol=1e-7)
    w = windows.detach().numpy().astype(np.float64)
    fd = (w[1:5] - w[5:9]) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=2e-3)


def test_kernel_path_refuses_grad():
    """The kernel has no backward: its wrapper raises under autograd,
    naming physics='torch', before it touches the kernel library, and
    physics='cuda' needs a CUDA device. (On the card,
    tests/test_torch_cuda.py drives the same refusal through env_step.)"""
    spec, st = _state("reach-v3", REACH_VEC)
    table, ids, blocks = tcore.step_tables(spec, "cpu", 1)
    act = torch.zeros(1, 4, requires_grad=True)
    mocap, target, effort = cuda_step._sim_and_ctl(table, ids, st.sim, act)
    ctl = torch.cat([target.T, effort[None]])
    rows = cuda_step.pack_sim_rows(st.sim)
    with pytest.raises(RuntimeError, match="physics='torch'"):
        cuda_step.launch_rows(table.rows, ids, rows, ctl, blocks)
    with pytest.raises(ValueError, match="CUDA"):
        tcore.env_step(spec, st, act, physics="cuda")
    # on the CPU the wrapper runs the plain version, which differentiates
    out = cuda_step.control_step(table, ids, st.sim, act, blocks)
    assert out.hand.requires_grad
