"""The CUDA kernel on the card (chip_smoke.py's checks at a small size).

Marked `cuda`; each test decides inside itself whether a GPU is present and
skips with a reason where there is none. Run on a machine with an NVIDIA
GPU (sm_90a) and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from metaworld_tpu_torch import benchmarks, vector
from metaworld_tpu_torch.physics import cuda_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the GPU")
    return torch.device("cuda")


def _engine(device, per_task, bench=benchmarks.MT10, **kw):
    bench = bench(seed=0, num_goals=5)
    names = list(bench.train_classes.keys())
    return vector.FusedBatchedEnvs(
        [bench.train_classes[n] for n in names], [per_task] * len(names),
        [bench.goal_table(n) for n in names], one_hot=True, device=device, **kw)


@pytest.mark.parametrize("bench", [benchmarks.MT10, benchmarks.MT25, benchmarks.MT50],
                         ids=["mt10", "mt25", "mt50"])
def test_kernel_matches_plain_every_variant(device, bench):
    eng = _engine(device, 200, bench)
    assert eng.physics == "cuda"
    assert min(eng.block_table.blocks_by_variant) > 0
    state, _ = eng.reset()
    sim = state.env.sim
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cuda_step.reset_counts()
    for _ in range(5):
        act = torch.rand(eng.num_envs, 4, generator=gen, device=device) * 2 - 1
        got = cuda_step.control_step(eng.scene_table, eng.task_ids, sim, act,
                                     eng.block_table)
        ref = cuda_step.plain_control_step(eng.scene_table, eng.task_ids, sim, act)
        torch.cuda.synchronize()
        for f in ref.__dataclass_fields__:
            err = (getattr(got, f) - getattr(ref, f)).abs().max().item()
            assert err <= 1e-4, f"{f} off by {err:.3e}"
        sim = ref
    assert cuda_step.launches == 5  # one launch per control step
    assert cuda_step.launches_by_variant == [5] * 4
    assert cuda_step.blocks_by_variant == [
        5 * c for c in eng.block_table.blocks_by_variant]


def test_wrapper_checks_inputs(device):
    eng = _engine(device, 3)
    state, _ = eng.reset()
    act = torch.zeros(eng.num_envs, 4, device=device)
    with pytest.raises(ValueError):
        cuda_step.launch_rows(eng.scene_table.rows, eng.task_ids.long(),
                              cuda_step.pack_sim_rows(state.env.sim),
                              torch.zeros(4, eng.num_envs, device=device),
                              eng.block_table)
    # a block table whose task ids run past the scene table
    past = cuda_step.block_table(np.full(eng.num_envs, 10), np.ones((11, 3), bool),
                                 device=device)
    with pytest.raises(ValueError):
        cuda_step.launch_rows(eng.scene_table.rows, eng.task_ids,
                              cuda_step.pack_sim_rows(state.env.sim),
                              torch.zeros(4, eng.num_envs, device=device), past)
    out = cuda_step.control_step(eng.scene_table, eng.task_ids, state.env.sim,
                                 act, eng.block_table)
    assert out.hand.device.type == "cuda"
    # no table: every block runs all features, with the same result
    out_all = cuda_step.control_step(eng.scene_table, eng.task_ids, state.env.sim, act)
    assert torch.equal(out_all.hand, out.hand)


def test_fused_step_kernel_matches_plain_physics_without_sync(device):
    kw = dict(max_episode_steps=4, task_select="pseudorandom")
    ek, ep = _engine(device, 6, **kw), _engine(device, 6, physics="torch", **kw)
    goal_idx = torch.arange(ek.num_envs, device=device, dtype=torch.int32) % 5
    sk, _ = ek.reset(goal_idx=goal_idx)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    acts = [torch.rand(ek.num_envs, 4, generator=gen, device=device) * 2 - 1
            for _ in range(12)]
    ek.step(sk, acts[0])
    torch.cuda.synchronize()
    outs_k = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = sk
        for a in acts:
            s, o = ek.step(s, a)
            outs_k.append(o)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    s = sk
    for a, ok in zip(acts, outs_k):
        s, op = ep.step(s, a)
        for k in vector.OUT_KEYS:
            np.testing.assert_allclose(ok[k].double().cpu().numpy(),
                                       op[k].double().cpu().numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    assert bool(torch.stack([o["done"] for o in outs_k]).any(0).all())


def test_ml_test_split_kernel_matches_plain_physics_without_sync(device):
    """ML10's test split (goal hidden, terminate_on_success) with the kernel
    against the plain physics, 12 steps with no host synchronisation."""
    bench = benchmarks.ML10(seed=0, num_goals=5)
    kw = dict(split="test", envs_per_task=6, terminate_on_success=True,
              max_episode_steps=4, task_select="pseudorandom", device=device)
    ek = vector.from_benchmark(bench, **kw)
    ep = vector.from_benchmark(bench, physics="torch", **kw)
    assert ek.physics == "cuda"
    goal_idx = torch.arange(ek.num_envs, device=device, dtype=torch.int32) % 5
    s, obs = ek.reset(goal_idx=goal_idx)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    acts = [torch.rand(ek.num_envs, 4, generator=gen, device=device) * 2 - 1
            for _ in range(12)]
    torch.cuda.synchronize()
    cuda_step.reset_counts()
    outs_k = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for a in acts:
            s, o = ek.step(s, a)
            outs_k.append(o)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_step.launches == len(acts)
    s, _ = ek.reset(goal_idx=goal_idx)
    for a, ok in zip(acts, outs_k):
        s, op = ep.step(s, a)
        assert bool((ok["obs"][:, 36:39] == 0).all())  # the goal is hidden
        for k in vector.OUT_KEYS:
            np.testing.assert_allclose(ok[k].double().cpu().numpy(),
                                       op[k].double().cpu().numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_experts_on_the_card_match_the_cpu(device):
    """Every expert on the card against the same expert on the CPU, on its
    golden observations: equal, the thresholds' norm included."""
    import pathlib

    from metaworld_tpu_torch.policies import get_policy, implemented_policies

    golden = pathlib.Path(__file__).parent / "golden"
    for name in implemented_policies():
        obs = torch.from_numpy(np.load(golden / f"{name}.npz")["obs"].astype(np.float32))
        pol = get_policy(name)
        torch.testing.assert_close(pol(obs.to(device)).cpu(), pol(obs), rtol=0, atol=0,
                                   msg=name)


def test_sawyer_env_on_the_card_matches_the_cpu(device):
    """SawyerEnv with the kernel at N = 1 against SawyerEnv on the CPU (the
    plain physics), 20 expert steps of push-v3, the CPU env restarted from
    the card's state each step: observations, rewards and infos within
    1e-4, one launch per step."""
    import metaworld_tpu_torch as mw
    from metaworld_tpu_torch.policies import get_policy

    task = mw.MT1("push-v3", seed=0, num_goals=1).train_tasks[0]
    card, cpu = (mw.SawyerEnv("push-v3", seed=0, device=d) for d in (device, "cpu"))
    for env in (card, cpu):
        env.set_task(task)
    obs, _ = card.reset()
    np.testing.assert_allclose(obs, cpu.reset()[0], rtol=0, atol=1e-6)
    pol = get_policy("push-v3")
    cuda_step.reset_counts()
    for _ in range(20):
        blob, path_length, _ = card.get_env_state()  # the generators differ by device
        cpu.set_env_state((blob, path_length, cpu._gen.get_state()))
        act = pol(torch.from_numpy(obs[None].astype(np.float32)))[0].numpy()
        obs, r, te, tr, info = card.step(act)
        obs_c, r_c, te_c, tr_c, info_c = cpu.step(act)
        np.testing.assert_allclose(obs, obs_c, rtol=0, atol=1e-4)
        assert abs(r - r_c) <= 1e-4 and (te, tr) == (te_c, tr_c)
        for k in info:
            assert abs(info[k] - info_c[k]) <= 1e-4, k
    assert cuda_step.launches == 20


def test_kernel_refuses_grad(device):
    """The kernel has no backward: under autograd env_step and the fused
    step raise and name physics='torch'; under no_grad the kernel runs, and
    physics='torch' differentiates on the card."""
    from metaworld_tpu_torch.envs import core, registry
    from metaworld_tpu_torch.types import MAX_RAND

    spec = registry.get_spec("reach-v3")
    st, _ = core.env_reset(spec, torch.zeros(1, MAX_RAND, device=device), 1.0)
    act = torch.zeros(1, 4, device=device, requires_grad=True)
    with pytest.raises(RuntimeError, match="physics='torch'"):
        core.env_step(spec, st, act)
    eng = vector.from_benchmark(benchmarks.MT1("reach-v3", seed=0, num_goals=2),
                                envs_per_task=2, device=device)
    state, _ = eng.reset()
    with pytest.raises(RuntimeError, match="physics='torch'"):
        eng.step(state, act.expand(2, 4))
    cuda_step.reset_counts()
    with torch.no_grad():
        core.env_step(spec, st, act)
    assert cuda_step.launches == 1
    _, out = core.env_step(spec, st, act, physics="torch")
    out.reward.sum().backward()
    assert bool(torch.isfinite(act.grad).all()) and cuda_step.launches == 1
