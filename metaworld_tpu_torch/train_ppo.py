"""End-to-end PPO training on the fused engine: rollout and learner on the
device, nothing read back by the host between env steps and gradient steps.

Counterpart of `scripts/train_ppo.py`. The JAX script runs one update
(rollout, GAE, PPO epochs) as one jitted program; here the rollout is a
Python loop over the fused step (one kernel launch per step on a CUDA
device) and the learner a loop of minibatch steps, as plain functions on
tensors: `policy_sample`, `rollout`, `gae`, `ppo_loss`, `learn` and
`update`. The rollout and GAE make no host synchronisation: the statistics
stay tensors until a line is printed.

    python -m metaworld_tpu_torch.train_ppo --env reach-v3 --updates 40
    python -m metaworld_tpu_torch.train_ppo --bench MT10 --envs-per-task 128
    python -m metaworld_tpu_torch.train_ppo --device cpu --envs-per-task 4 \\
        --rollout 4 --updates 2

Model-free PPO on Meta-World needs millions of env steps; a few dozen
updates demonstrate the wiring, not a solved task. Prints one JSON line
every 10 updates and after the last, with the JAX script's keys.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch
from torch import nn

from metaworld_tpu_torch import benchmarks, vector, wrappers
from metaworld_tpu_torch.tracing import span
from metaworld_tpu_torch.train_apg import dense

_LOG_2PI = math.log(2 * math.pi)


class ActorCritic(nn.Module):
    """The flax `ActorCritic` of scripts/train_ppo.py: separate actor and
    critic trunks of two tanh layers (the value target is O(100), and a
    shared trunk lets the value gradient wreck the policy features), a tanh
    mean (bounded: an unbounded mean and an action clip saturate the
    policy), a state-independent `log_std` initialised to -0.5 and clipped
    to [-3, 0.5], and a linear value head. Layers take flax `Dense`'s init.
    """

    def __init__(self, obs_dim: int, hidden: int = 256):
        super().__init__()
        self.actor = nn.ModuleList([dense(obs_dim, hidden), dense(hidden, hidden)])
        self.mean = dense(hidden, 4)
        self.log_std = nn.Parameter(torch.full((4,), -0.5))
        self.critic = nn.ModuleList([dense(obs_dim, hidden), dense(hidden, hidden)])
        self.value = dense(hidden, 1)

    def forward(self, x):
        ha = x
        for layer in self.actor:
            ha = torch.tanh(layer(ha))
        hv = x
        for layer in self.critic:
            hv = torch.tanh(layer(hv))
        return (torch.tanh(self.mean(ha)), torch.clamp(self.log_std, -3.0, 0.5),
                self.value(hv)[..., 0])


def log_prob(act, mean, log_std):
    return (-0.5 * (((act - mean) / torch.exp(log_std)) ** 2 + 2 * log_std
                    + _LOG_2PI)).sum(-1)


def policy_sample(model, obs, gen):
    """(action clipped to [-1, 1], log-probability of the unclipped sample,
    value), the noise drawn from `gen`."""
    mean, log_std, value = model(obs)
    noise = torch.randn(mean.shape, generator=gen, device=mean.device)
    act = mean + torch.exp(log_std) * noise
    return torch.clamp(act, -1.0, 1.0), log_prob(act, mean, log_std), value


@torch.no_grad()
def rollout(model, envs, vstate, obs, steps: int, gen):
    """`steps` steps of the policy on `envs` (a fused engine or an
    `EnvPipeline`). Returns (vstate, obs, trajectory, last value): the
    trajectory is a dict of (steps, n, ...) tensors obs, act, logp, value,
    reward, done, success."""
    keys = ("obs", "act", "logp", "value", "reward", "done", "success")
    traj = {k: [] for k in keys}
    with span("ppo.rollout"):
        for _ in range(steps):
            with span("ppo.policy"):
                act, logp, value = policy_sample(model, obs, gen)
            vstate, out = envs.step(vstate, act)
            done = (out["terminated"] | out["truncated"]).to(torch.float32)
            for k, v in zip(keys, (obs, act, logp, value, out["reward"], done,
                                   out["success"])):
                traj[k].append(v)
            obs = out["obs"]
        _, _, last_value = model(obs)
        return vstate, obs, {k: torch.stack(v) for k, v in traj.items()}, last_value


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """Generalised advantage estimates over (T, n) rewards, values and
    dones; returns (advantages, returns)."""
    with span("ppo.gae"):
        advs = [None] * rewards.shape[0]
        adv = torch.zeros_like(last_value)
        next_value = last_value
        for t in reversed(range(rewards.shape[0])):
            delta = rewards[t] + gamma * next_value * (1 - dones[t]) - values[t]
            adv = delta + gamma * lam * (1 - dones[t]) * adv
            advs[t] = adv
            next_value = values[t]
        advs = torch.stack(advs)
        return advs, advs + values


def ppo_loss(model, batch, clip: float):
    """Clipped surrogate + 0.5 value loss - 5e-3 entropy on one minibatch
    (obs, act, old logp, advantage, return); advantages are normalised per
    minibatch."""
    obs, act, old_logp, adv, ret = batch
    mean, log_std, value = model(obs)
    ratio = torch.exp(log_prob(act, mean, log_std) - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(ratio * adv_n,
                        torch.clamp(ratio, 1 - clip, 1 + clip) * adv_n).mean()
    vloss = torch.square(value - ret).mean()
    ent = (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum()
    return pg + 0.5 * vloss - 5e-3 * ent


def make_optimizer(model, lr: float, total_steps: int):
    """Adam on optax's `cosine_decay_schedule(lr, total_steps, alpha=0.1)`:
    the rate of the k-th step is lr * (0.9 * (1 + cos(pi k / total)) / 2 +
    0.1). Returns (optimizer, scheduler); call the scheduler's `step()`
    after each optimizer step (`optimizer_step`)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def factor(k):
        cos = 0.5 * (1 + math.cos(math.pi * min(k, total_steps) / total_steps))
        return 0.9 * cos + 0.1

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def optimizer_step(model, opt, sched, loss):
    """Backward, clip the gradients' global norm to 0.5, Adam step, and
    advance the schedule."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    nn.utils.clip_grad_norm_(model.parameters(), 0.5)
    opt.step()
    sched.step()


def learn(model, opt, sched, traj, adv, ret, epochs: int, minibatches: int,
          clip: float, gen):
    """`epochs` passes over the flattened trajectory, each in `minibatches`
    minibatches of a fresh permutation drawn from `gen`. Returns the mean
    loss (a tensor)."""
    with span("ppo.learn"):
        flat = [x.reshape((-1,) + x.shape[2:])
                for x in (traj["obs"], traj["act"], traj["logp"], adv, ret)]
        n = flat[0].shape[0]
        losses = []
        for _ in range(epochs):
            perm = torch.randperm(n, generator=gen, device=flat[0].device)
            mbs = [x[perm].reshape((minibatches, -1) + x.shape[1:]) for x in flat]
            for i in range(minibatches):
                with span("ppo.minibatch"):
                    loss = ppo_loss(model, [x[i] for x in mbs], clip)
                    optimizer_step(model, opt, sched, loss)
                losses.append(loss.detach())
        return torch.stack(losses).mean()


def update(model, opt, sched, envs, vstate, obs, gen, args):
    """One PPO update: rollout, GAE and the learner. Returns (vstate, obs,
    stats), the statistics as tensors."""
    vstate, obs, traj, last_value = rollout(model, envs, vstate, obs,
                                            args.rollout, gen)
    adv, ret = gae(traj["reward"], traj["value"], traj["done"], last_value,
                   args.gamma, args.lam)
    loss = learn(model, opt, sched, traj, adv, ret, args.epochs,
                 args.minibatches, args.clip, gen)
    return vstate, obs, {"loss": loss, "mean_reward": traj["reward"].mean(),
                         "success_rate": traj["success"].amax(0).mean()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default=None, help="single env name (MT1)")
    ap.add_argument("--num-goals", type=int, default=50,
                    help="goals per task (MT1 path only)")
    ap.add_argument("--bench", default=None, help="MT10/MT25/MT50")
    ap.add_argument("--envs-per-task", type=int, default=64)
    ap.add_argument("--rollout", type=int, default=64)
    ap.add_argument("--updates", type=int, default=50)
    ap.add_argument("--minibatches", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--lam", type=float, default=0.95)
    ap.add_argument("--clip", type=float, default=0.2)
    ap.add_argument("--reward-norm", action="store_true",
                    help="normalize rewards with the gymnasium-style "
                         "discounted-return normalizer (EnvPipeline)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def setup(args):
    """(envs, model, optimizer, scheduler, generator) for `args`."""
    if args.bench:
        bench = getattr(benchmarks, args.bench)(seed=args.seed)
        one_hot = True
    else:
        bench = benchmarks.MT1(args.env or "reach-v3", seed=args.seed,
                               num_goals=args.num_goals)
        one_hot = False
    envs = vector.from_benchmark(bench, envs_per_task=args.envs_per_task,
                                 one_hot=one_hot, device=args.device,
                                 seed=args.seed)
    if args.reward_norm:
        envs = wrappers.EnvPipeline(envs, reward_normalization_method="gymnasium",
                                    reward_norm_gamma=args.gamma)
    torch.manual_seed(args.seed)
    model = ActorCritic(envs.obs_dim).to(envs.device)
    opt, sched = make_optimizer(model, args.lr,
                                args.updates * args.epochs * args.minibatches)
    gen = torch.Generator(device=envs.device)
    gen.manual_seed(args.seed)
    return envs, model, opt, sched, gen


def run(args) -> list[dict]:
    """Train; prints and returns the statistics of every 10th update and
    of the last."""
    envs, model, opt, sched, gen = setup(args)
    vstate, obs = envs.reset(seed=args.seed)
    rows = []
    t0 = time.time()
    for i in range(args.updates):
        vstate, obs, stats = update(model, opt, sched, envs, vstate, obs, gen,
                                    args)
        if i % 10 == 0 or i == args.updates - 1:
            row = {"update": i, **{k: float(v) for k, v in stats.items()}}
            sps = envs.num_envs * args.rollout * (i + 1) / (time.time() - t0)
            rows.append(row)
            print(json.dumps({"update": i,
                              **{k: round(float(v), 4) for k, v in stats.items()},
                              "env_steps_per_s": round(sps)}), flush=True)
    return rows


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
