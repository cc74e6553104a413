"""Behavior cloning from a recorded dataset: scripted experts -> the native
trajectory store -> a supervised policy -> closed-loop evaluation on the
fused engine.

Counterpart of `scripts/train_bc.py`. Records expert rollouts through
`native.TrajectoryWriter` (unless `--data` names an existing file), fits
`train_apg.Pi` (256 hidden units) by MSE with Adam over minibatches of 512,
and reports closed-loop success on fresh goals.

    python -m metaworld_tpu_torch.train_bc --env drawer-open-v3
    python -m metaworld_tpu_torch.train_bc --device cpu --epochs 5

The default dataset path is `bc_<env>.ts` in the temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from metaworld_tpu_torch import benchmarks, vector
from metaworld_tpu_torch.native import TrajectoryReader, TrajectoryWriter
from metaworld_tpu_torch.policies import get_policy
from metaworld_tpu_torch.train_apg import Pi

BATCH = 512
EPISODE_STEPS = 500


def record_expert(envs, policy, writer, steps: int, seed: int):
    """`steps` steps of the expert `policy` from a reset with `seed`, one
    record of (obs, effective action) per step. The effective action has
    its xyz clipped to [-1, 1], as the engine clips the mocap delta: some
    experts emit heavy-tailed raw magnitudes (drawer-open peaks above 5)
    that are noise to the clone and behave exactly as their clip."""
    state, obs = envs.reset(seed=seed)
    for _ in range(steps):
        acts = policy(obs)
        state, out = envs.step(state, acts)
        rec = torch.cat([torch.clamp(acts[:, :3], -1.0, 1.0), acts[:, 3:]], 1)
        writer.write({"obs": obs, "action": rec})
        obs = out["obs"]
    writer.flush()


def load(path, device):
    """(X, Y): every record's observations and actions, float32 on `device`."""
    obs, act = [], []
    for rec in TrajectoryReader(path):
        obs.append(rec["obs"])
        act.append(rec["action"])
    X = torch.from_numpy(np.concatenate(obs).astype(np.float32)).to(device)
    Y = torch.from_numpy(np.concatenate(act).astype(np.float32)).to(device)
    return X, Y


def bc_epoch(pi, opt, X, Y, perm):
    """One pass of Adam steps on the MSE over minibatches of BATCH rows
    taken in the order `perm` (the tail that fills no minibatch is left
    out). Returns the mean minibatch loss (a tensor)."""
    nb = X.shape[0] // BATCH
    idxs = perm[: nb * BATCH].reshape(nb, BATCH)
    losses = []
    for idx in idxs:
        loss = torch.mean(torch.square(pi(X[idx]) - Y[idx]))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).mean()


def fit(pi, X, Y, epochs: int, lr: float, seed: int):
    """`epochs` epochs of `bc_epoch` with Adam at `lr`, each on a fresh
    permutation from a generator seeded with `seed`. Returns the epochs'
    mean losses (tensors)."""
    opt = torch.optim.Adam(pi.parameters(), lr=lr)
    gen = torch.Generator(device=X.device)
    gen.manual_seed(seed)
    return [bc_epoch(pi, opt, X, Y, torch.randperm(X.shape[0], generator=gen,
                                                   device=X.device))
            for _ in range(epochs)]


@torch.no_grad()
def evaluate(pi, envs, seed: int):
    """Closed loop from a reset with `seed` (fresh goals): each slot's
    success is its max over EPISODE_STEPS steps. Returns the success rate (a
    tensor)."""
    state, obs = envs.reset(seed=seed)
    succ = torch.zeros(envs.num_envs, device=envs.device)
    for _ in range(EPISODE_STEPS):
        state, out = envs.step(state, pi(obs))
        obs = out["obs"]
        succ = torch.maximum(succ, out["success"])
    return succ.mean()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="drawer-open-v3")
    ap.add_argument("--data", default=None,
                    help="existing dataset; default records a fresh one")
    ap.add_argument("--record-episodes", type=int, default=1)
    ap.add_argument("--envs-per-task", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-episodes", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run(args) -> dict:
    """Record (unless --data), fit and evaluate; prints the JAX script's
    lines and returns {"losses": per-epoch mean losses, "success_rate",
    "policy", "envs"}."""
    envs = vector.from_benchmark(benchmarks.MT1(args.env, seed=args.seed),
                                 envs_per_task=args.envs_per_task,
                                 device=args.device)
    data_path = args.data
    if data_path is None:
        data_path = os.path.join(tempfile.gettempdir(), f"bc_{args.env}.ts")
        t0 = time.time()
        with TrajectoryWriter(data_path) as w:
            record_expert(envs, get_policy(args.env), w,
                          args.record_episodes * EPISODE_STEPS, args.seed)
        print(f"recorded {data_path} in {time.time()-t0:.1f}s")
    X, Y = load(data_path, envs.device)
    print(f"dataset: {X.shape[0]} transitions")

    torch.manual_seed(args.seed)
    pi = Pi(X.shape[1], hidden=256).to(envs.device)
    losses = fit(pi, X, Y, args.epochs, args.lr, args.seed + 1)
    print(f"final BC loss: {float(losses[-1]):.5f}")

    succ = float(evaluate(pi, envs, args.seed + 100))
    print(json.dumps({"env": args.env, "bc_success_rate": succ}))
    return {"losses": losses, "success_rate": succ, "policy": pi, "envs": envs}


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
