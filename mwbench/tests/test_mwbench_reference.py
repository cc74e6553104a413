"""The frozen reference against the program on the CPU: the fused step of
MT10 and MT50 at a few envs per task, across an autoreset, and the PPO
pieces on one small batch."""

from __future__ import annotations

import pytest
import torch

from metaworld_tpu_torch import train_ppo
from mwbench import compare, program
from mwbench.reference import ppo as rppo
from mwbench.reference.fused import Layout, state_from_tree

SEED = 2**31 + 12345
LIMITS = {"state_gap": 0.0, "reward_gap": 0.0}


@pytest.mark.parametrize("benchmark,per_task", [("MT10", 2), ("MT50", 1)])
def test_fused_step_matches_program(benchmark, per_task):
    cfg = {"benchmark": benchmark, "reward_function_version": "v2", "goal_visible": True,
           "one_hot": True, "max_episode_steps": 500, "task_select": "random",
           "autoreset": True}
    n = per_task * (10 if benchmark == "MT10" else 50)
    envs = program.build_envs({**cfg, "n_envs": n}, SEED, "cpu")
    lay = Layout(benchmark, n, program.goal_seed(SEED), "cpu")
    st, obs = envs.reset(seed=5)
    rows, unmatched = lay.match_rows(st.env.rand_vec, torch.ones(n, dtype=torch.bool))
    assert unmatched == 0
    assert compare.mixed_gap(obs, lay.reset_state(rows)[1]) == 0.0
    g = torch.Generator().manual_seed(1)
    # path lengths 497..499: every slot truncates within three steps and is
    # reset on the step after
    pl = torch.randint(0, 3, (n,), generator=g).int() + 497
    st = st.replace(env=st.env.replace(path_length=pl))
    resets = 0
    for _ in range(5):
        act = torch.rand(n, 4, generator=g) * 2 - 1
        new, out = envs.step(st, act)
        rows, unmatched = lay.match_rows(new.env.rand_vec, st.pending_reset)
        assert unmatched == 0
        resets += int(st.pending_reset.sum())
        ref_new, ref_out = lay.step(state_from_tree(compare.as_tree(st)), act, rows)
        nums, bad = compare.step_numbers(new, out, ref_new, ref_out, LIMITS)
        assert bad == 0, nums
        st = new
    assert resets == n


def test_ppo_pieces_match_program():
    torch.manual_seed(0)
    n, t, d = 64, 4, 13
    model = train_ppo.ActorCritic(d, 32)
    ref = rppo.ActorCritic(d, 32)
    ref.load_state_dict(model.state_dict())
    obs = torch.randn(t, n, d)
    got, want = [], []
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    for i in range(t):
        got.append(train_ppo.policy_sample(model, obs[i], g1))
        want.append(rppo.policy_sample(ref, obs[i], g2))
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.allclose(x, y, atol=1e-6)
    rew, done = torch.randn(t, n), (torch.rand(t, n) < 0.1).float()
    val = torch.stack([v for _, _, v in got]).detach()
    last = torch.randn(n)
    for x, y in zip(train_ppo.gae(rew, val, done, last, 0.99, 0.95),
                    rppo.gae(rew, val, done, last, 0.99, 0.95)):
        assert torch.allclose(x, y, atol=1e-5)
    adv, ret = rppo.gae(rew, val, done, last, 0.99, 0.95)
    traj = {"obs": obs, "act": torch.stack([a for a, _, _ in got]).detach(),
            "logp": torch.stack([lp for _, lp, _ in got]).detach()}
    opt, sched = train_ppo.make_optimizer(model, 3e-4, 40)
    adam = rppo.Adam(ref.parameters(), 3e-4, 40)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
    l1 = train_ppo.learn(model, opt, sched, traj, adv, ret, 2, 4, 0.2,
                         torch.Generator().manual_seed(9))
    l2 = rppo.learn(ref, adam, flat(traj["obs"]), flat(traj["act"]), flat(traj["logp"]),
                    flat(adv), flat(ret), 2, 4, 0.2, torch.Generator().manual_seed(9))
    assert abs(float(l1) - float(l2)) <= 1e-5 * abs(float(l2))
    for (_, p), (_, q) in zip(model.named_parameters(), ref.named_parameters()):
        assert torch.allclose(p, q, atol=1e-6)
