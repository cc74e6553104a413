"""The CUDA kernel on the card (chip_smoke.py's checks at a small size).

Marked `cuda`; each test decides inside itself whether a GPU is present and
skips with a reason where there is none. Run on a machine with an NVIDIA
GPU (sm_90a) and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from metaworld_tpu_torch import benchmarks, tracing, vector
from metaworld_tpu_torch.devices import no_host_sync
from metaworld_tpu_torch.physics import cuda_step
from metaworld_tpu_torch.types import tree_leaves, tree_map

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


def test_fused_step_with_the_tracer_on_makes_no_sync_and_one_launch(device):
    """The same steps with the tracer off and on, under
    `set_sync_debug_mode("error")`: the same outputs to the bit, one kernel
    launch a step; a replay's spans are `step` and `step.graph`, and the
    layers' spans ran once, at the capture inside the constructor, with the
    kernel's spans inside `step.physics`."""
    tracing.enable()
    eng = _engine(device, 6, max_episode_steps=4, task_select="pseudorandom")
    built, _ = tracing.take()
    goal_idx = torch.arange(eng.num_envs, device=device, dtype=torch.int32) % 5
    s0, _ = eng.reset(goal_idx=goal_idx)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    acts = [torch.rand(eng.num_envs, 4, generator=gen, device=device) * 2 - 1
            for _ in range(6)]
    keep = tree_map(torch.clone, s0)
    torch.cuda.synchronize()
    runs = []
    for on in (False, True):
        cuda_step.reset_counts()
        if on:
            tracing.enable()
        outs = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            s = keep
            for a in acts:
                s, o = eng.step(s, a)
                outs.append(o)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            records, _ = tracing.take()
        assert cuda_step.launches == len(acts)
        runs.append((outs, records))
    (off, none), (on, records) = runs
    assert none == []
    for o_off, o_on in zip(off, on):
        for k in vector.OUT_KEYS:
            assert torch.equal(o_off[k], o_on[k]), k
    names = [r.name for r in records]
    assert names == ["step", "step.graph"] * len(acts)
    assert all(records[r.parent].name == "step" for r in records if r.name == "step.graph")
    # the eager step before the capture and the captured step
    layers = ["step.physics", "physics.weld", "physics.pack", "physics.launch",
              "physics.unpack", "step.guard", "step.tails", "step.autoreset"]
    names = [r.name for r in built]
    assert names.count("engine.graph") == 1 and "step" not in names
    assert [n for n in names if n in layers] == layers * 2
    for r in built:
        if r.name in layers[1:5]:
            assert built[r.parent].name == "step.physics"
            assert built[r.parent].start_ns <= r.start_ns <= r.end_ns
        elif r.name in layers:
            assert built[r.parent].name == "engine.graph"


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


# ---------------------------------------------------------------------------
# the fused step as one CUDA graph per engine
# ---------------------------------------------------------------------------

def _bits(t):
    """A tensor's bits, comparable with ==."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _flat(tree) -> list:
    """The tensors of a tree of dataclasses, dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return tree_leaves(tree)


def _differ(a, b):
    """A device scalar: how many elements of two trees' leaves differ in
    their bits (no host sync)."""
    a, b = _flat(a), _flat(b)
    assert len(a) == len(b)
    return sum((_bits(x) != _bits(y)).sum() for x, y in zip(a, b))


class _Eager:
    """An engine whose `step` is the eager step, op by op."""

    def __init__(self, eng):
        self.eng = eng

    def __getattr__(self, name):
        return getattr(self.eng, name)

    def step(self, state, actions):
        return self.eng._step(state, actions)


@pytest.mark.parametrize("bench,per_task,select", [
    (benchmarks.MT10, 40, "random"),
    (benchmarks.MT10, 40, "pseudorandom"),
    (benchmarks.MT50, 8, "pseudorandom")],
    ids=["mt10-random", "mt10-pseudorandom", "mt50-pseudorandom"])
def test_graph_replays_equal_the_eager_step_bit_for_bit(device, bench, per_task, select):
    """600 steps of staggered 50-step episodes (ended at success too under
    pseudorandom), so every slot resets a dozen times: the graph's outputs,
    state and generator against an engine of the same layout and seed
    stepped op by op, bit for bit; one capture per engine, every step a
    replay, one kernel launch a step, no host sync."""
    before = vector.graph_captures
    kw = dict(max_episode_steps=50, task_select=select, seed=3,
              terminate_on_success=select == "pseudorandom")
    eng, ref = _engine(device, per_task, bench, **kw), _engine(device, per_task, bench, **kw)
    assert vector.graph_captures == before + 2
    n = eng.num_envs
    goal_idx = torch.arange(n, device=device, dtype=torch.int32) % 5
    s, _ = eng.reset(seed=11, goal_idx=goal_idx)
    r, _ = ref.reset(seed=11, goal_idx=goal_idx)
    # staggered episodes: path lengths 0..49
    pl = torch.arange(n, device=device, dtype=torch.int32) % 50
    s = s.replace(env=s.env.replace(path_length=pl))
    r = r.replace(env=r.env.replace(path_length=pl.clone()))
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    differ = torch.zeros((), dtype=torch.int64, device=device)
    resets = torch.zeros((), dtype=torch.int64, device=device)
    torch.cuda.synchronize()
    vector.reset_counts()
    cuda_step.reset_counts()
    with no_host_sync():
        for t in range(600):
            act = torch.rand(n, 4, generator=gen, device=device) * 2 - 1
            pending = r.pending_reset
            s, o = eng.step(s, act)
            r, o_ref = ref._step(r, act)
            differ += _differ(o, o_ref) + _differ(s, r)
            resets += pending.sum()
    assert vector.graph_captures == 0 and vector.graph_replays == 600
    assert vector.eager_steps == 0 and vector.hit_share() == 1.0
    assert vector.state_copy_ins == len(tree_leaves(s))  # the first step only
    assert cuda_step.launches == 2 * 600
    assert int(differ) == 0
    assert int(resets) >= 10 * n
    assert torch.equal(eng._gen.get_state(), ref._gen.get_state())


def test_graph_generator_reseed_and_set_state(device):
    """Random-mode autoresets under the graph: two replays draw different
    rows, the generator after k replays is where k eager steps leave it,
    and `reset(seed=...)` and `set_state` between replays are honoured."""
    kw = dict(max_episode_steps=1, seed=9)
    eng, ref = _engine(device, 30, **kw), _engine(device, 30, **kw)
    act = torch.zeros(eng.num_envs, 4, device=device)
    s, _ = eng.reset(seed=1)
    r, _ = ref.reset(seed=1)
    rand = []
    for k in range(4):
        s, _ = eng.step(s, act)
        r, _ = ref._step(r, act)
        assert torch.equal(eng._gen.get_state(), ref._gen.get_state()), k
        rand.append(s.env.rand_vec.clone())
    # every slot resets every other step: steps 1 and 3 drew new rows
    assert not torch.equal(rand[1], rand[3])
    assert int(_differ(s, r)) == 0
    s, _ = eng.reset(seed=2)
    r, _ = ref.reset(seed=2)
    for _ in range(3):
        s, o = eng.step(s, act)
        r, o_ref = ref._step(r, act)
    assert int(_differ(o, o_ref) + _differ(s, r)) == 0
    # set_state: the same draws again from a clone of the state
    g, keep = eng._gen.get_state(), tree_map(torch.clone, s)
    s, o1 = eng.step(s, act)
    s1 = tree_map(torch.clone, eng.step(s, act)[0])
    eng._gen.set_state(g)
    s, o2 = eng.step(keep, act)
    s2 = eng.step(s, act)[0]
    assert int(_differ(o1, o2) + _differ(s1, s2)) == 0


def test_graph_engine_draws_as_an_engine_that_never_captured(device):
    """The constructor's eager step and capture leave the generator where
    the seed and the reset table's rejection draws put it, as in an engine
    with the plain physics, which captures nothing; so a graphed engine's
    first unseeded reset and its autoresets draw that engine's goal rows."""
    kw = dict(max_episode_steps=1, seed=9)
    eng, plain = _engine(device, 30, **kw), _engine(device, 30, physics="torch", **kw)
    assert plain._graph is None
    assert torch.equal(eng._gen.get_state(), plain._gen.get_state())
    s, obs = eng.reset()
    p, obs_p = plain.reset()
    assert torch.equal(obs, obs_p) and torch.equal(s.env.rand_vec, p.env.rand_vec)
    act = torch.zeros(eng.num_envs, 4, device=device)
    for k in range(4):
        s, _ = eng.step(s, act)
        p, _ = plain.step(p, act)
        assert torch.equal(s.env.rand_vec, p.env.rand_vec), k
    assert torch.equal(eng._gen.get_state(), plain._gen.get_state())


def test_graph_step_settings_recapture(device):
    """The graph holds `terminate_on_success` and `max_episode_steps` as
    they were at its capture: setting either to a new value captures again
    (the same value does not), and the replays then end episodes as the
    eager step with the new value does, bit for bit. The experts drive
    reach-v3 to success, so the toggle decides `terminated`."""
    from metaworld_tpu_torch.evaluation import ScriptedAgent

    bench = benchmarks.MT1("reach-v3", seed=0, num_goals=50)
    kw = dict(envs_per_task=64, max_episode_steps=200, task_select="pseudorandom",
              device=device)
    eng, ref = vector.from_benchmark(bench, **kw), vector.from_benchmark(bench, **kw)
    agent = ScriptedAgent(eng)
    goal_idx = torch.arange(64, device=device, dtype=torch.int32) % 50
    s, obs = eng.reset(goal_idx=goal_idx)
    r, _ = ref.reset(goal_idx=goal_idx)
    differ = torch.zeros((), dtype=torch.int64, device=device)
    ended = torch.zeros((), dtype=torch.int64, device=device)

    def steps(k):
        nonlocal s, r, obs, differ, ended
        for _ in range(k):
            act = agent.eval_action(obs)
            s, o = eng.step(s, act)
            r, o_ref = ref._step(r, act)
            differ += _differ(o, o_ref) + _differ(s, r)
            ended += o["terminated"].sum()
            obs = o["obs"]

    steps(10)
    before = vector.graph_captures
    for e in (eng, ref):
        e.terminate_on_success = True
    assert vector.graph_captures == before + 2
    eng.terminate_on_success = True
    assert vector.graph_captures == before + 2
    steps(60)
    assert int(ended) > 0  # the experts succeeded and the replays ended episodes
    for e in (eng, ref):
        e.max_episode_steps = 75
    assert vector.graph_captures == before + 4
    steps(30)
    assert int(differ) == 0
    assert vector.graph_captures == before + 4


def test_graph_ppo_rollout_equals_the_eager_rollout(device):
    """A 16-step `train_ppo.rollout` keeps every step's outputs by reference:
    its trajectory under the graph equals the eager engine's to the bit."""
    from metaworld_tpu_torch import train_ppo

    eng, ref = _engine(device, 20, max_episode_steps=5), _engine(device, 20, max_episode_steps=5)
    torch.manual_seed(0)
    model = train_ppo.ActorCritic(eng.obs_dim, 32).to(device)
    res = []
    for envs in (eng, _Eager(ref)):
        gen = torch.Generator(device=device)
        gen.manual_seed(4)
        state, obs = envs.reset(seed=8)
        with torch.no_grad():
            res.append(train_ppo.rollout(model, envs, state, obs, 16, gen))
    (sg, og, tg, vg), (se, oe, te, ve) = res
    assert int(_differ(tg, te) + _differ(sg, se) + _differ(og, oe) + _differ(vg, ve)) == 0
    assert bool(tg["done"].any())


def test_sharded_and_gym_batch_on_the_card_equal_eager(device):
    """Two shards on one card (one engine and graph each, stepped on its own
    stream) and `GymVectorBatch` against the same layouts stepped op by op."""
    from metaworld_tpu_torch.gym_adapter import GymVectorBatch
    from metaworld_tpu_torch.parallel import ShardedEnvs

    bench = benchmarks.MT10(seed=0, num_goals=5)
    kw = dict(devices=["cuda:0"] * 2, max_episode_steps=5)
    sh, ref = ShardedEnvs(bench, 20, **kw), ShardedEnvs(bench, 20, **kw)
    for shard in ref.shards:
        shard.step = shard._step
    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    sts, _ = sh.reset(seed=3)
    rts, _ = ref.reset(seed=3)
    differ = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(12):
        act = torch.rand(sh.num_envs, 4, generator=gen, device=device) * 2 - 1
        sts, outs = sh.step(sts, act)
        rts, routs = ref.step(rts, act)
        differ += _differ(outs, routs) + _differ(sts, rts)
    assert int(differ) == 0

    batches = [GymVectorBatch(_engine(device, 3, max_episode_steps=5), seed=2)
               for _ in range(2)]
    batches[1].envs = _Eager(batches[1].envs)
    first = [b.reset()[0] for b in batches]
    np.testing.assert_array_equal(*first)
    rng = np.random.default_rng(0)
    for _ in range(12):
        act = rng.uniform(-1, 1, (batches[0].num_envs, 4)).astype(np.float32)
        got, want = (b.step(act) for b in batches)
        for x, y in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(x, y)
        for k in ("success", "episode_return", "episode_length"):
            np.testing.assert_array_equal(got[4][k], want[4][k])
