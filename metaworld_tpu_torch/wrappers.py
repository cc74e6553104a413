"""Functional wrappers over the fused engine (counterpart of
`metaworld_tpu/wrappers.py`).

Every wrapper is a pure state transform over the batched engine: its state
is a dataclass of tensors carried next to the engine's `FusedState`, and
`checkpoint` / `restore` serialise the lot. The mapping to the reference's
wrapper stack is the JAX package's (`metaworld_tpu/wrappers.py:9-19`).

Differences in form, not in result:

  * Variances are population variances (`correction=0`), as `jnp.var`
    computes them.
  * `PseudoRandomGoals` draws its permutations from a `torch.Generator`
    whose state it carries in its `key` field, one stream for all slots
    where the JAX wrapper keeps a threefry key per slot; its draws differ
    from JAX's, its cycle is the same.
  * The engine keeps the generator its random-mode autoresets draw from, so
    `checkpoint` / `restore` take the engine as an optional argument and
    carry that generator's state; the JAX package keeps its keys in the
    state itself.
"""

from __future__ import annotations

import dataclasses
import io

import torch

from metaworld_tpu_torch.types import _Tree


# ---------------------------------------------------------------------------
# reward normalizers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunningStat(_Tree):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, shape=(), device="cuda"):
        return cls(mean=torch.zeros(shape, device=device),
                   var=torch.ones(shape, device=device),
                   count=torch.full((), 1e-4, device=device))

    def update(self, batch):
        b_mean = batch.mean(dim=0)
        b_var = batch.var(dim=0, correction=0)
        b_count = batch.shape[0]
        delta = b_mean - self.mean
        tot = self.count + b_count
        mean = self.mean + delta * b_count / tot
        m_a = self.var * self.count
        m_b = b_var * b_count
        m2 = m_a + m_b + torch.square(delta) * self.count * b_count / tot
        return RunningStat(mean=mean, var=m2 / tot, count=tot)


@dataclasses.dataclass
class DiscountedRewardNormState(_Tree):
    returns: torch.Tensor   # (n,) running discounted return
    stat: RunningStat


class DiscountedRewardNorm:
    """Gymnasium-style NormalizeReward: scales rewards by the std of the
    discounted return (the reference's reward_normalization_method=
    "gymnasium")."""

    def __init__(self, num_envs: int, gamma: float = 0.99, eps: float = 1e-8,
                 device="cuda"):
        self.gamma = gamma
        self.eps = eps
        self.num_envs = num_envs
        self.device = torch.device(device)

    def init(self):
        return DiscountedRewardNormState(
            returns=torch.zeros(self.num_envs, device=self.device),
            stat=RunningStat.create(device=self.device))

    def __call__(self, state, reward, done):
        returns = state.returns * self.gamma * (1.0 - done) + reward
        stat = state.stat.update(returns)
        norm = reward / torch.sqrt(stat.var + self.eps)
        return DiscountedRewardNormState(returns=returns, stat=stat), norm


@dataclasses.dataclass
class ExponentialRewardNormState(_Tree):
    mean: torch.Tensor
    var: torch.Tensor
    initialized: torch.Tensor


class ExponentialRewardNorm:
    """EMA mean/var normalizer (ref NormalizeRewardsExponential)."""

    def __init__(self, alpha: float = 0.001, eps: float = 1e-8, device="cuda"):
        self.alpha = alpha
        self.eps = eps
        self.device = torch.device(device)

    def init(self):
        return ExponentialRewardNormState(
            mean=torch.zeros((), device=self.device),
            var=torch.ones((), device=self.device),
            initialized=torch.zeros((), dtype=torch.bool, device=self.device))

    def __call__(self, state, reward, done=None):
        b_mean = reward.mean()
        b_var = reward.var(correction=0)
        mean = torch.where(state.initialized,
                           (1 - self.alpha) * state.mean + self.alpha * b_mean,
                           b_mean)
        var = torch.where(state.initialized,
                          (1 - self.alpha) * state.var + self.alpha * b_var,
                          torch.clamp(b_var, min=self.eps))
        norm = (reward - mean) / torch.sqrt(var + self.eps)
        return ExponentialRewardNormState(
            mean=mean, var=var, initialized=torch.ones_like(state.initialized)
        ), norm


@dataclasses.dataclass
class ObservationNormState(_Tree):
    stat: RunningStat


class ObservationNorm:
    """Running mean/var observation whitening (the reference's
    normalize_observations=True path)."""

    def __init__(self, obs_dim: int, eps: float = 1e-8, device="cuda"):
        self.obs_dim = obs_dim
        self.eps = eps
        self.device = torch.device(device)

    def init(self):
        return ObservationNormState(
            stat=RunningStat.create((self.obs_dim,), device=self.device))

    def __call__(self, state, obs):
        stat = state.stat.update(obs)
        norm = (obs - stat.mean) / torch.sqrt(stat.var + self.eps)
        return ObservationNormState(stat=stat), norm


# ---------------------------------------------------------------------------
# RNN meta-RL observation augmentation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RNNMetaRLState(_Tree):
    prev_action: torch.Tensor  # (n, 4)
    prev_reward: torch.Tensor  # (n,)
    prev_done: torch.Tensor    # (n,)


class RNNMetaRLAugment:
    """Appends [prev_action(4), prev_reward(1), done(1)] to the observation
    for RNN meta-learners (ref RNNBasedMetaRLWrapper)."""

    def __init__(self, num_envs: int, normalize_reward: bool = False,
                 device="cuda"):
        self.num_envs = num_envs
        self.scale = 0.1 if normalize_reward else 1.0
        self.extra_dims = 6
        self.device = torch.device(device)

    def init(self):
        n, dev = self.num_envs, self.device
        return RNNMetaRLState(prev_action=torch.zeros(n, 4, device=dev),
                              prev_reward=torch.zeros(n, device=dev),
                              prev_done=torch.zeros(n, device=dev))

    def augment(self, state, obs):
        return torch.cat(
            [obs, state.prev_action, (state.prev_reward * self.scale)[:, None],
             state.prev_done[:, None]], dim=1)

    def update(self, state, action, reward, done):
        return RNNMetaRLState(prev_action=action, prev_reward=reward,
                              prev_done=done.float())


# ---------------------------------------------------------------------------
# pseudo-random (cycling) goal selection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PseudoRandomGoalState(_Tree):
    perm: torch.Tensor    # (n, n_goals) per-env goal permutation
    cursor: torch.Tensor  # (n,) next index into perm
    key: torch.Tensor     # the permutation generator's state (uint8, host)


class PseudoRandomGoals:
    """Cycles each env through all goals without repetition, reshuffling each
    epoch (ref PseudoRandomTaskSelectWrapper)."""

    def __init__(self, num_envs: int, n_goals: int, device="cuda"):
        self.num_envs = num_envs
        self.n_goals = n_goals
        self.device = torch.device(device)

    def _perms(self, key):
        """(new key, (n, n_goals) permutations drawn from the generator in
        state `key`)."""
        gen = torch.Generator(device=self.device)
        gen.set_state(key)
        u = torch.rand(self.num_envs, self.n_goals, generator=gen,
                       device=self.device)
        return gen.get_state(), torch.argsort(u, dim=1).int()

    def init(self, seed: int):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        key, perm = self._perms(gen.get_state())
        return PseudoRandomGoalState(
            perm=perm, cursor=torch.zeros(self.num_envs, dtype=torch.int32,
                                          device=self.device), key=key)

    def next_goal(self, state, advance_mask):
        """Returns (new_state, goal_idx (n,)). Envs with advance_mask move
        their cursor; wrapping reshuffles their permutation."""
        idx = torch.gather(state.perm, 1, state.cursor[:, None].long())[:, 0]
        cursor = torch.where(advance_mask, state.cursor + 1, state.cursor)
        wrap = cursor >= self.n_goals
        key, nperm = self._perms(state.key)
        perm = torch.where(wrap[:, None], nperm, state.perm)
        cursor = torch.where(wrap, 0, cursor)
        return PseudoRandomGoalState(perm=perm, cursor=cursor, key=key), idx


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    """The tensors of a tree of dataclasses and tuples, in field order
    (None holds none)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return [t for sub in tree for t in _leaves(sub)]


def _fill(template, leaves):
    """`template` with its tensors replaced, in order, from the iterator
    `leaves`, each moved to its template tensor's device."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        t = next(leaves, None)
        if t is None or t.shape != template.shape or t.dtype != template.dtype:
            got = "nothing" if t is None else f"{tuple(t.shape)} {t.dtype}"
            raise ValueError(f"checkpoint leaf {got} does not fit the template's "
                             f"{tuple(template.shape)} {template.dtype}")
        return t.to(template.device)
    if dataclasses.is_dataclass(template):
        return type(template)(**{f.name: _fill(getattr(template, f.name), leaves)
                                 for f in dataclasses.fields(template)})
    return type(template)(_fill(sub, leaves) for sub in template)


def _unflatten(template, leaves: list):
    it = iter(leaves)
    out = _fill(template, it)
    if next(it, None) is not None:
        raise ValueError("the checkpoint holds more tensors than the template")
    return out


def checkpoint(vstate, wrapper_states=None, envs=None) -> bytes:
    """Serialize the batch state (+ wrapper states) to bytes; with `envs`
    (the engine or a pipeline around it), also the state of the engine's
    generator, from which random-mode autoresets draw their goals. The host
    RNG of `sample_tasks` is not carried, as in the JAX package."""
    payload = {"vstate": [t.detach().cpu() for t in _leaves(vstate)]}
    if wrapper_states is not None:
        payload["wrappers"] = [t.detach().cpu() for t in _leaves(wrapper_states)]
    if envs is not None:
        payload["generator"] = envs._gen.get_state()
    buf = io.BytesIO()
    torch.save(payload, buf)
    return buf.getvalue()


def restore(template_vstate, data: bytes, wrapper_templates=None, envs=None):
    """Inverse of checkpoint(): the templates supply the structure and the
    devices; with `envs`, the engine's generator is set back to the
    checkpoint's state."""
    payload = torch.load(io.BytesIO(data), weights_only=True)
    vstate = _unflatten(template_vstate, payload["vstate"])
    if envs is not None:
        envs._gen.set_state(payload["generator"])
    if wrapper_templates is None:
        return vstate
    return vstate, _unflatten(wrapper_templates, payload["wrappers"])


# ---------------------------------------------------------------------------
# wrapper-stack assembly
# ---------------------------------------------------------------------------


class EnvPipeline:
    """The reference's per-env wrapper assembly as one state transform
    (JAX wrappers.py:269-340, ref metaworld/__init__.py:398-457).

    Wrapper order matches the reference's nesting (inner -> outer): engine
    (TimeLimit + AutoTerminateOnSuccess + OneHot are engine flags) -> RNN
    meta-RL obs augmentation -> reward normalization -> observation
    normalization. The RNN wrapper therefore sees raw rewards, and the
    observation normalizer whitens the augmented observation.

    State is the tuple (vstate, rnorm_state, onorm_state, rnn_state). The
    step makes no host synchronisation.
    """

    def __init__(self, envs, reward_normalization_method: str | None = None,
                 normalize_observations: bool = False,
                 recurrent_info_in_obs: bool = False,
                 normalize_rnn_reward: bool = False,
                 reward_norm_gamma: float = 0.99):
        assert reward_normalization_method in (None, "none", "gymnasium",
                                               "exponential"), \
            reward_normalization_method
        self.envs = envs
        self.num_envs = envs.num_envs
        dev = envs.device
        self.rnorm = None
        if reward_normalization_method == "gymnasium":
            self.rnorm = DiscountedRewardNorm(envs.num_envs,
                                              gamma=reward_norm_gamma, device=dev)
        elif reward_normalization_method == "exponential":
            self.rnorm = ExponentialRewardNorm(device=dev)
        self.rnn = (RNNMetaRLAugment(envs.num_envs, normalize_rnn_reward,
                                     device=dev)
                    if recurrent_info_in_obs else None)
        self.obs_dim = envs.obs_dim + (self.rnn.extra_dims if self.rnn else 0)
        self.onorm = (ObservationNorm(self.obs_dim, device=dev)
                      if normalize_observations else None)

    def reset(self, seed: int | None = None):
        vstate, obs = self.envs.reset(seed=seed)
        rnorm_s = self.rnorm.init() if self.rnorm else None
        rnn_s = self.rnn.init() if self.rnn else None
        if self.rnn:
            obs = self.rnn.augment(rnn_s, obs)
        onorm_s = self.onorm.init() if self.onorm else None
        if self.onorm:
            onorm_s, obs = self.onorm(onorm_s, obs)
        return (vstate, rnorm_s, onorm_s, rnn_s), obs

    def step(self, state, actions):
        vstate, rnorm_s, onorm_s, rnn_s = state
        vstate, out = self.envs.step(vstate, actions)
        out = dict(out)
        done = out["terminated"] | out["truncated"]
        raw_reward = out["reward"]
        if self.rnn:
            rnn_s = self.rnn.update(rnn_s, actions, raw_reward, done)
            out["obs"] = self.rnn.augment(rnn_s, out["obs"])
        if self.rnorm:
            rnorm_s, out["reward"] = self.rnorm(rnorm_s, raw_reward, done.float())
        if self.onorm:
            onorm_s, out["obs"] = self.onorm(onorm_s, out["obs"])
        return (vstate, rnorm_s, onorm_s, rnn_s), out

    def __getattr__(self, name):
        # delegate everything else (task_names, sample_tasks, the generator,
        # ...) to the underlying engine, like a gymnasium wrapper would
        if name == "envs":
            raise AttributeError(name)
        return getattr(self.envs, name)
