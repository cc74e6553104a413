"""The port's multi-device engine (`metaworld_tpu_torch.parallel`).

`ShardedEnvs` over eight CPU "devices" is bit-equal to running each
shard's local engine by hand with that shard's seed and actions (the
pattern of tests/test_sharded_pipeline.py); the divisibility guard and
`shard_batch`'s split-or-replicate rule hold; and the port agrees with the
JAX package's `ShardedEnvs` on conftest's 8-device CPU mesh on
`MT1("reach-v3", seed=0, num_goals=4)`, 16 envs, pinned goals and 3-step
episodes, starting from the JAX reset state carried over by
`convert.sharded_from_dict` (the JAX reset draws from its key). Each step
restarts the port from the JAX state; outputs are held at
test_torch_fused.py's tolerances (observations 1e-5, rewards and metrics
1e-5 relative or 1e-6 absolute, flags and counters exact).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metaworld_tpu as jmw
from metaworld_tpu.parallel import mesh as jmesh
from metaworld_tpu.parallel.sharded import ShardedEnvs as JShardedEnvs
from metaworld_tpu_torch import benchmarks as tbench
from metaworld_tpu_torch import convert
from metaworld_tpu_torch.parallel import ShardedEnvs, make_env_mesh, shard_batch, shard_seed
from tests.test_torch_fused import _compare_out

CPU8 = ["cpu"] * 8
STEPS = 3  # steps of the hand-run check (the JAX comparison crosses an autoreset)


def test_sharded_envs_matches_local():
    """Bit-equal to each shard's local engine run by hand: shard i resets
    with shard_seed(seed, i, 8) and steps its slice of the actions."""
    bench = tbench.MT1("reach-v3", seed=0, num_goals=4)
    envs = ShardedEnvs(bench, envs_per_task=16, devices=CPU8)
    assert envs.n_shards == 8 and envs.num_envs == 16
    assert envs.obs_dim == 39 and envs.task_names == ["reach-v3"]
    states, obs = envs.reset(seed=3)
    assert [o.shape for o in obs] == [(2, 39)] * 8
    rng = np.random.default_rng(7)
    acts = rng.uniform(-1, 1, size=(STEPS, 16, 4)).astype(np.float32)
    sharded = []
    for t in range(STEPS):
        # a global tensor and a list of per-shard tensors alike
        a = torch.from_numpy(acts[t])
        states, outs = envs.step(states, a if t % 2 else list(a.split(2)))
        sharded.append(envs.gather(outs, keys=("obs", "reward", "done",
                                               "episode_return")))
    local = envs.local
    for i in range(8):
        st, ob = local.reset(seed=shard_seed(3, i, 8))
        assert torch.equal(ob, obs[i])
        for t in range(STEPS):
            st, out = local.step(st, torch.from_numpy(acts[t, 2 * i:2 * i + 2]))
            for k, v in sharded[t].items():
                assert torch.equal(v[2 * i:2 * i + 2], out[k]), (i, t, k)
    # the seeds differ per shard, so the random goal draws do too
    assert len({tuple(o[0, 36:39].tolist()) for o in obs}) > 1


def test_sharded_envs_divisibility_guard():
    with pytest.raises(AssertionError):
        ShardedEnvs(tbench.MT1("reach-v3", seed=0, num_goals=2),
                    envs_per_task=12, devices=CPU8)


@dataclasses.dataclass
class _Leaves:
    batch: torch.Tensor
    table: np.ndarray
    scalar: torch.Tensor


def test_shard_batch_splits_or_replicates():
    devices = make_env_mesh(devices=["cpu"] * 4)
    assert devices == [torch.device("cpu")] * 4
    assert make_env_mesh(n_devices=2, devices=["cpu"] * 4) == devices
    tree = {"x": _Leaves(batch=torch.arange(8.0).reshape(8, 1),
                         table=np.arange(6).reshape(3, 2),
                         scalar=torch.tensor(5.0)),
            "empty": torch.zeros(0, 2)}
    parts = shard_batch(tree, devices)
    assert len(parts) == 4
    for i, p in enumerate(parts):
        assert torch.equal(p["x"].batch, torch.tensor([[2.0 * i], [2.0 * i + 1]]))
        assert torch.equal(p["x"].table, torch.arange(6).reshape(3, 2))
        assert p["x"].scalar.item() == 5.0
        assert p["empty"].shape == (0, 2)


def test_make_env_mesh_needs_a_device_list_without_cuda():
    if torch.cuda.is_available():
        assert make_env_mesh() == [torch.device("cuda", i)
                                   for i in range(torch.cuda.device_count())]
    else:
        with pytest.raises(RuntimeError):
            make_env_mesh()


def test_sharded_envs_matches_jax_sharded():
    kw = dict(task_select="pseudorandom", max_episode_steps=3)
    je = JShardedEnvs(jmw.MT1("reach-v3", seed=0, num_goals=4),
                      envs_per_task=16, mesh=jmesh.make_env_mesh(8), **kw)
    te = ShardedEnvs(tbench.MT1("reach-v3", seed=0, num_goals=4),
                     envs_per_task=16, devices=CPU8, **kw)
    sj, oj = je.reset(jax.random.PRNGKey(0))
    assert len(sj.env.sim.hand.sharding.device_set) == 8
    rng = np.random.default_rng(0)
    crossed = False
    for t in range(4):
        act = rng.uniform(-1, 1, (16, 4)).astype(np.float32)
        st = convert.sharded_from_dict(convert.as_dict(sj), CPU8)
        sj, out_j = je.step(sj, jnp.asarray(act))
        st, outs = te.step(st, torch.from_numpy(act))
        out_t = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        _compare_out(out_j, out_t, f"t={t}")
        crossed |= bool(np.asarray(out_j["episode_length"] == 1).any() and t > 0)
    assert crossed
