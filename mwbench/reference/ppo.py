"""PPO in plain PyTorch: the actor-critic, the policy sample, GAE, the
clipped loss, gradient clipping by global norm, Adam and its cosine
schedule, and the learner's epochs of minibatches.

Written out from the recipe of `metaworld_tpu_torch/train_ppo.py` (commit
3742bce) and from torch.optim.Adam's documented update rule; it calls no
optimizer of torch and nothing of the program.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

LOG_2PI = math.log(2 * math.pi)


class ActorCritic(nn.Module):
    """Two tanh trunks of `hidden` units (actor, critic), a tanh mean, a
    state-independent log-std clipped to [-3, 0.5] and a linear value head;
    parameter names as the program's model has them."""

    def __init__(self, obs_dim: int, hidden: int = 256):
        super().__init__()
        self.actor = nn.ModuleList([nn.Linear(obs_dim, hidden), nn.Linear(hidden, hidden)])
        self.mean = nn.Linear(hidden, 4)
        self.log_std = nn.Parameter(torch.full((4,), -0.5))
        self.critic = nn.ModuleList([nn.Linear(obs_dim, hidden), nn.Linear(hidden, hidden)])
        self.value = nn.Linear(hidden, 1)

    def forward(self, x):
        ha = x
        for layer in self.actor:
            ha = torch.tanh(F.linear(ha, layer.weight, layer.bias))
        hv = x
        for layer in self.critic:
            hv = torch.tanh(F.linear(hv, layer.weight, layer.bias))
        mean = torch.tanh(F.linear(ha, self.mean.weight, self.mean.bias))
        value = F.linear(hv, self.value.weight, self.value.bias)[..., 0]
        return mean, torch.clamp(self.log_std, -3.0, 0.5), value


def log_prob(act, mean, log_std):
    return (-0.5 * (((act - mean) / torch.exp(log_std)) ** 2 + 2 * log_std
                    + LOG_2PI)).sum(-1)


def policy_sample(model, obs, gen):
    mean, log_std, value = model(obs)
    noise = torch.randn(mean.shape, generator=gen, device=mean.device)
    act = mean + torch.exp(log_std) * noise
    return torch.clamp(act, -1.0, 1.0), log_prob(act, mean, log_std), value


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    adv = torch.zeros_like(last_value)
    next_value = last_value
    advs = []
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * next_value * (1 - dones[t]) - values[t]
        adv = delta + gamma * lam * (1 - dones[t]) * adv
        advs.append(adv)
        next_value = values[t]
    advs = torch.stack(advs[::-1])
    return advs, advs + values


def ppo_loss(model, obs, act, old_logp, adv, ret, clip: float):
    mean, log_std, value = model(obs)
    ratio = torch.exp(log_prob(act, mean, log_std) - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(ratio * adv_n, torch.clamp(ratio, 1 - clip, 1 + clip) * adv_n).mean()
    vloss = torch.square(value - ret).mean()
    ent = (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum()
    return pg + 0.5 * vloss - 5e-3 * ent


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) on `lr * factor(k)` at step k, with
    factor(k) = 0.9 (1 + cos(pi min(k, total) / total)) / 2 + 0.1."""

    def __init__(self, params, lr: float, total_steps: int):
        self.params = list(params)
        self.lr, self.total, self.k = lr, total_steps, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    def rate(self) -> float:
        k = min(self.k, self.total)
        return self.lr * (0.9 * 0.5 * (1 + math.cos(math.pi * k / self.total)) + 0.1)

    @torch.no_grad()
    def step(self, grads):
        lr, t = self.rate(), self.k + 1
        c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).add_(g * g, alpha=0.001)
            p.sub_((lr / c1) * m / (v.sqrt() / math.sqrt(c2) + 1e-8))
        self.k += 1


def clipped_grads(loss, params, max_norm: float = 0.5):
    grads = torch.autograd.grad(loss, params)
    total = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return [g * coef for g in grads]


def learn(model, adam, obs, act, logp, adv, ret, epochs: int, minibatches: int,
          clip: float, gen, first_grads=None):
    """The learner over flattened (rows, ...) tensors; returns the mean
    minibatch loss. `first_grads`, a list, receives the clipped gradients of
    the first minibatch step."""
    flat = (obs, act, logp, adv, ret)
    n = obs.shape[0]
    params = list(model.parameters())
    losses = []
    for _ in range(epochs):
        perm = torch.randperm(n, generator=gen, device=obs.device)
        mbs = [x[perm].reshape((minibatches, -1) + x.shape[1:]) for x in flat]
        for i in range(minibatches):
            loss = ppo_loss(model, *[x[i] for x in mbs], clip)
            grads = clipped_grads(loss, params)
            if first_grads is not None and not first_grads:
                first_grads.extend(g.detach().clone() for g in grads)
            adam.step(grads)
            losses.append(loss.detach())
    return torch.stack(losses).mean()
