"""Analytic policy gradients: training by backprop through the physics.

Counterpart of `scripts/train_apg.py` (single device). Every update resets
the batch to fresh goals, unrolls `horizon` steps of the policy through
`vector.BatchedEnvs` (the plain PyTorch lane engine, which autograd
differentiates; the CUDA kernel has no backward) and takes one Adam step
on the time-weighted negative mean reward, with the gradient's global norm
clipped to 1. Fresh resets per update keep the visited states anchored:
carrying states across updates lets early bad policies drift the batch
into workspace corners where the mocap clip zeroes the gradient.

    python -m metaworld_tpu_torch.train_apg --env reach-v3 --updates 150
    python -m metaworld_tpu_torch.train_apg --device cpu --envs-per-task 8

Prints one JSON line every 15 updates and after the last.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch
from torch import nn

from metaworld_tpu_torch import benchmarks, vector


def dense(n_in: int, n_out: int) -> nn.Linear:
    """A linear layer with flax `Dense`'s default init: a LeCun-normal
    kernel and a zero bias."""
    layer = nn.Linear(n_in, n_out)
    # flax's lecun_normal: truncated normal at 2 std, rescaled to
    # variance 1 / fan_in
    std = math.sqrt(1.0 / n_in) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(layer.bias)
    return layer


class Pi(nn.Module):
    """Two tanh layers of `hidden` units and a tanh head of 4 actions (the
    flax `Pi` of scripts/train_apg.py and scripts/train_bc.py: Dense layers
    with LeCun-normal kernels and zero biases)."""

    def __init__(self, obs_dim: int, hidden: int = 128):
        super().__init__()
        self.layers = nn.ModuleList([dense(obs_dim, hidden),
                                     dense(hidden, hidden), dense(hidden, 4)])

    def forward(self, x):
        for layer in self.layers:
            x = torch.tanh(layer(x))
        return x


def episode_loss(pi: nn.Module, envs, horizon: int, **reset_kw):
    """Reset, unroll `horizon` steps of `pi` and return (loss, mean reward,
    success rate): the loss weights later steps up (linspace(0.3, 1) over
    the steps: reach the goal and stay there); the success rate is the
    share of slots that succeeded at any step."""
    state, obs = envs.reset(**reset_kw)
    rews, succ = [], []
    for _ in range(horizon):
        state, out = envs.step(state, pi(obs))
        obs = out["obs"]
        rews.append(out["reward"])
        succ.append(out["success"])
    rews = torch.stack(rews)
    w = torch.linspace(0.3, 1.0, horizon, device=rews.device)[:, None]
    loss = -(w * rews).mean()
    return loss, rews.detach().mean(), torch.stack(succ).amax(0).mean()


def update(pi: nn.Module, opt: torch.optim.Optimizer, envs, horizon: int):
    """One APG update; returns (loss, mean reward, success rate) tensors."""
    opt.zero_grad(set_to_none=True)
    loss, reward, success = episode_loss(pi, envs, horizon)
    loss.backward()
    torch.nn.utils.clip_grad_norm_(pi.parameters(), 1.0)
    opt.step()
    return loss.detach(), reward, success


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="reach-v3")
    ap.add_argument("--envs-per-task", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=60)
    ap.add_argument("--updates", type=int, default=150)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    torch.manual_seed(args.seed)
    envs = vector.from_benchmark(benchmarks.MT1(args.env, seed=args.seed),
                                 envs_per_task=args.envs_per_task, fused=False,
                                 device=args.device, seed=args.seed + 1)
    pi = Pi(envs.obs_dim, args.hidden).to(envs.device)
    opt = torch.optim.Adam(pi.parameters(), lr=args.lr)
    t0 = time.time()
    for i in range(args.updates):
        _, r, s = update(pi, opt, envs, args.horizon)
        if i % 15 == 0 or i == args.updates - 1:
            print(json.dumps({
                "update": i,
                "mean_reward": round(float(r), 3),
                "success_rate": round(float(s), 3),
                "wall_s": round(time.time() - t0, 1),
                "device": str(envs.device),
            }), flush=True)


if __name__ == "__main__":
    main()
