"""The one generator of traffic. A traffic file (`traffic/<name>.json`)
names its loop by `kind` and sets every parameter of it; the loops are
closed, each step waiting on nothing but the program's own queue.

- `rollout`: every step draws fresh uniform actions in [low, high) from a
  `torch.Generator` seeded from `--seed`, runs the fused step and adds the
  step's reward sum into a device scalar; the host reads nothing inside the
  window. Every slot starts at a path length drawn uniformly over the
  episode, so that a share of the slots resets on every step (the engine's
  autoreset costs the same work on every step).
- `ppo`: PPO training on the fused engine (`train_ppo.rollout`, `gae` and
  `learn` with its optimizer), the model's weights made from the seed.

Each loop has `setup` (build, warm up; counted in `setup_s`), `window`
(the measured seconds), `profile` (a short traced segment after the window)
and `check` (the comparison with the plain reference, after the window).
"""

from __future__ import annotations

import math
import random
import time

import torch

from mwbench import compare, program


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Marks:
    """Points in time on the device's stream (CUDA events; the host clock
    on the CPU), recorded without waiting."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.points = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.points.append(ev)
        else:
            self.points.append(time.perf_counter())

    def intervals_ms(self) -> list:
        p = self.points
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(p, p[1:])]
        return [(b - a) * 1e3 for a, b in zip(p, p[1:])]


def label(name):
    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# rollout
# ---------------------------------------------------------------------------

class Rollout:
    def __init__(self, cell, seed: int, dev, trace: bool):
        self.cell, self.seed, self.dev, self.trace = cell, seed, dev, trace
        self.tr = cell.traffic
        self.spans = {}

    def setup(self):
        tr, dev, seed = self.tr, self.dev, self.seed
        self.envs = envs = program.build_envs(self.cell.config, seed, dev)
        self.n = envs.num_envs
        self.lo, self.hi = float(tr["actions"]["low"]), float(tr["actions"]["high"])
        self.gen = program.generator(dev, seed, 1)
        state, _ = envs.reset(seed=program.stream(seed, 2))
        # staggered episodes: every slot starts at a path length drawn over
        # the episode, so that a share of the slots resets on every step
        pl = torch.randint(0, envs.max_episode_steps, (self.n,),
                           generator=program.generator(dev, seed, 3),
                           device=dev, dtype=torch.int32)
        state = state.replace(env=state.env.replace(path_length=pl))
        self.total = torch.zeros((), device=dev)
        for _ in range(max(1, int(tr["warmup_steps"]))):
            new, out, act = self._step(state)
            state = new
        # host buffers for the two steps the check compares: (before: the
        # state and actions handed to the step; after: its state and outputs)
        self.buffers = [(compare.HostCopy({"state": state, "act": act}),
                         compare.HostCopy({"state": new, "out": out}))
                        for _ in range(2)]
        self.state = state
        sync(dev)

    def _actions(self):
        u = torch.rand(self.n, 4, generator=self.gen, device=self.dev)
        return u * (self.hi - self.lo) + self.lo

    def _step(self, state):
        act = self._actions()
        new, out = self.envs.step(state, act)
        self.total = self.total + out["reward"].sum()
        return new, out, act

    def window(self, seconds: float) -> dict:
        """Steps until `seconds` have passed. The check compares the step
        that the seed samples among the first `within_first` and the last
        one, whose inputs and outputs are copied to the host as the stream
        reaches them: the loop holds on the device only what it steps."""
        within = int(self.tr["compare"]["within_first"])
        sampled = random.Random(program.stream(self.seed, 4)).randrange(within)
        (early_in, early_out), (last_in, last_out) = self.buffers
        self.compared = []
        marks = Marks(self.dev) if self.trace else None
        enqueue = []
        state, k = self.state, 0
        self.state = None
        sync(self.dev)
        t0 = time.perf_counter()
        if marks:
            marks.mark()
        while True:
            final = time.perf_counter() - t0 >= seconds
            act = self._actions()
            if final:
                last_in.put({"state": state, "act": act})
            elif k == sampled:
                early_in.put({"state": state, "act": act})
            if marks:
                h0 = time.perf_counter()
                new, out = self.envs.step(state, act)
                enqueue.append(time.perf_counter() - h0)
            else:
                new, out = self.envs.step(state, act)
            self.total = self.total + out["reward"].sum()
            if marks:
                marks.mark()
            if k == sampled and not final:
                self.compared.append((early_in, early_out.put({"state": new, "out": out})))
            state, k = new, k + 1
            if final:
                break
        sync(self.dev)
        t1 = time.perf_counter()
        self.compared.append((last_in, last_out.put({"state": state, "out": out})))
        sync(self.dev)
        self.state = state
        if marks:
            self.spans["step_ms"] = marks.intervals_ms()
            self.spans["enqueue_ms"] = [s * 1e3 for s in enqueue]
        return {"steps": k, "env_steps": k * self.n, "window_s": t1 - t0}

    def profile(self, steps: int):
        """`steps` more steps of the same traffic, each part labelled."""
        state = self.state
        for _ in range(steps):
            with label("mwbench.actions"):
                act = self._actions()
            with label("mwbench.step"):
                state, out = self.envs.step(state, act)
            with label("mwbench.reward_sum"):
                self.total = self.total + out["reward"].sum()
        self.state = state

    def layout(self) -> dict:
        return {"tasks": list(self.envs.task_names), "counts": list(self.envs.counts),
                "n_envs": self.n, "steps_per_unit": 1}

    def release(self):
        """Drop what the check does not read."""
        self.state = None
        self.envs = None

    def check(self, limits: dict, ref_dtype=None) -> tuple:
        """(numbers, env-steps compared, env-steps rejected) of the compared
        steps against the reference. `ref_dtype` (the control) puts the
        reference in the program's place with its state, actions and
        outputs stored in that dtype."""
        from mwbench.reference.fused import Layout, state_from_tree

        cfg, dev = self.cell.config, self.dev
        finite = bool(torch.isfinite(self.total))
        lay = Layout(cfg["benchmark"], self.n, program.goal_seed(self.seed), dev,
                     max_episode_steps=cfg["max_episode_steps"],
                     **cfg.get("benchmark_args", {}))
        nums, compared, bad = {}, 0, 0
        for inputs, outputs in self.compared:
            before, after = inputs.tree(dev), outputs.tree(dev)
            ref_in, act = state_from_tree(before["state"]), before["act"]
            rows, unmatched = lay.match_rows(after["state"]["env"]["rand_vec"],
                                             before["state"]["pending_reset"])
            rs, ro = lay.step(ref_in, act, rows)
            got_s, got_o = after["state"], after["out"]
            if ref_dtype is not None:
                got_s, got_o = _lowered(lay, ref_in, act, rows, ref_dtype)
            s, b = compare.step_numbers(got_s, got_o, rs, ro, limits)
            nums = compare.merge(nums, {**s, "reset_unmatched": float(unmatched)})
            bad += b
            compared += self.n
        nums["nonfinite_reward_sum"] = 0.0 if finite else 1.0
        return nums, compared, bad


def _round(t, dtype):
    return t.to(dtype).to(t.dtype) if t.is_floating_point() else t


def _lowered(lay, ref_in, act, rows, dtype):
    """The reference's step with its state, actions and outputs rounded to
    `dtype`: the control that stands in the program's place."""
    from mwbench.reference.fused import FusedState
    from mwbench.reference.types import tree_map

    st = tree_map(lambda t: _round(t, dtype), ref_in)
    st = FusedState(**{k: getattr(st, k) for k in ("env", "pending_reset",
                                                  "episode_return", "episode_length",
                                                  "goal_idx")})
    rs, ro = lay.step(st, _round(act, dtype), rows)
    rs = tree_map(lambda t: _round(t, dtype), rs)
    ro = {k: _round(v, dtype) for k, v in ro.items()}
    return rs, ro


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------

def init_weights(named, gen) -> dict:
    """Weights made on the device from `gen`: each matrix a normal clipped
    at two deviations and scaled to variance 1 / fan_in as flax's
    lecun_normal, each bias zero, the log-std -0.5. {name: tensor}."""
    out = {}
    for name, p in named:
        if p.dim() == 2:
            std = math.sqrt(1.0 / p.shape[1]) / 0.87962566103423978
            out[name] = torch.randn(p.shape, generator=gen, device=p.device).clamp_(-2, 2) * std
        elif name == "log_std":
            out[name] = torch.full_like(p, -0.5)
        else:
            out[name] = torch.zeros_like(p)
    return out


def _host(x):
    return x.detach().to("cpu", copy=True)


class PPO:
    def __init__(self, cell, seed: int, dev, trace: bool):
        self.cell, self.seed, self.dev, self.trace = cell, seed, dev, trace
        self.tr = cell.traffic
        self.p = cell.traffic["ppo"]
        self.spans = {}

    def setup(self):
        """The one training object, driven from the seed through its first
        updates by the window's own call; the reference follows them."""
        from metaworld_tpu_torch import train_ppo

        self.tp = train_ppo
        p, dev, seed = self.p, self.dev, self.seed
        self.envs = envs = program.build_envs(self.cell.config, seed, dev)
        self.n = envs.num_envs
        self.model = model = train_ppo.ActorCritic(envs.obs_dim, int(p["hidden"])).to(dev)
        self.names = [n for n, _ in model.named_parameters()]
        self.theta0 = init_weights(model.named_parameters(), program.generator(dev, seed, 5))
        with torch.no_grad():
            for name, prm in model.named_parameters():
                prm.copy_(self.theta0[name])
        per_update = int(p["epochs"]) * int(p["minibatches"])
        self.opt, self.sched = train_ppo.make_optimizer(
            model, float(p["lr"]), int(p["schedule_updates"]) * per_update)
        self.gen = program.generator(dev, seed, 6)
        vstate, obs = envs.reset(seed=program.stream(seed, 2))
        self.start = ({n: _host(t) for n, t in compare.leaves(vstate)}, _host(obs))
        self.first_moment = {}

        def first_step(opt, args, kwargs):
            if not self.first_moment:
                self.first_moment.update({n: _host(m) for n, m in self._moments()[0].items()})

        hook = self.opt.register_step_post_hook(first_step)
        self.captures = []
        for _ in range(max(1, int(p["followed_updates"]))):
            vstate, obs, res = self.update(vstate, obs)
            self.captures.append(self._host_result(res))
            res = None  # an update's trajectory is not held through the next
        hook.remove()
        self.theta_after = {n: _host(t) for n, t in model.named_parameters()}
        self.before_last = compare.HostCopy(self._learner_state())
        self.vstate, self.obs = vstate, obs
        sync(dev)

    def _moments(self) -> tuple:
        """({name: Adam's first moment}, {name: its second moment})."""
        params = self.opt.param_groups[0]["params"]
        st = [(prm, self.opt.state[prm]) for prm in params]
        # zeros before the optimizer's first step
        return ({n: s.get("exp_avg", torch.zeros_like(prm)) for n, (prm, s) in zip(self.names, st)},
                {n: s.get("exp_avg_sq", torch.zeros_like(prm)) for n, (prm, s) in zip(self.names, st)})

    def _learner_state(self) -> dict:
        m, v = self._moments()
        return {"theta": dict(self.model.named_parameters()), "m": m, "v": v}

    @staticmethod
    def _host_result(res) -> dict:
        cap = {k: _host(res["traj"][k]) for k in ("obs", "act", "logp", "value",
                                                  "reward", "done")}
        cap.update({k: _host(res[k]) for k in ("last_obs", "last_value", "adv", "ret")})
        cap["loss"] = float(res["loss"])
        return cap

    def update(self, vstate, obs, marks=None):
        """One PPO update: rollout, GAE and the learner (the window's call).
        Returns (vstate, obs, what the update produced)."""
        tp, p = self.tp, self.p
        if marks:
            marks["rollout"].mark()
        vstate, nxt, traj, last_value = tp.rollout(
            self.model, self.envs, vstate, obs, int(p["rollout"]), self.gen)
        if marks:
            marks["rollout"].mark()
        adv, ret = tp.gae(traj["reward"], traj["value"], traj["done"], last_value,
                          float(p["gamma"]), float(p["lam"]))
        if marks:
            marks["learn"].mark()
        loss = tp.learn(self.model, self.opt, self.sched, traj, adv, ret,
                        int(p["epochs"]), int(p["minibatches"]), float(p["clip"]),
                        self.gen)
        if marks:
            marks["learn"].mark()
        return vstate, nxt, {"traj": traj, "last_obs": nxt, "last_value": last_value,
                             "adv": adv, "ret": ret, "loss": loss}

    def window(self, seconds: float) -> dict:
        """Updates until `seconds` have passed. The check follows the last
        one from the program's own state before it: the learner's state is
        copied to the host as the stream reaches it, with the generator's
        state and the schedule's step; what the update produced is copied
        once the window has closed."""
        marks = ({"rollout": Marks(self.dev), "learn": Marks(self.dev)}
                 if self.trace else None)
        vstate, obs, k = self.vstate, self.obs, 0
        sync(self.dev)
        t0 = time.perf_counter()
        while True:
            final = time.perf_counter() - t0 >= seconds
            if final:
                self.before_last.put(self._learner_state())
                self.last_gen, self.last_k = self.gen.get_state(), self.sched.last_epoch
            vstate, obs, res = self.update(vstate, obs, marks=marks)
            k += 1
            if final:
                break
            res = None
        sync(self.dev)
        t1 = time.perf_counter()
        self.last = self._host_result(res)
        self.theta_last = {n: _host(t) for n, t in self.model.named_parameters()}
        self.vstate, self.obs = vstate, obs
        if marks:
            roll = marks["rollout"].intervals_ms()[::2]
            self.spans["rollout_step_ms"] = [r / int(self.p["rollout"]) for r in roll]
            self.spans["learn_ms"] = marks["learn"].intervals_ms()[::2]
        steps = k * int(self.p["rollout"])
        return {"steps": steps, "updates": k, "env_steps": steps * self.n,
                "window_s": t1 - t0}

    def profile(self, updates: int):
        vstate, obs = self.vstate, self.obs
        for _ in range(updates):
            with label("mwbench.update"):
                vstate, obs = self.update(vstate, obs)[:2]
        self.vstate, self.obs = vstate, obs

    def layout(self) -> dict:
        return {"tasks": list(self.envs.task_names), "counts": list(self.envs.counts),
                "n_envs": self.n, "steps_per_unit": int(self.p["rollout"])}

    def release(self):
        self.vstate = self.obs = self.envs = None
        self.model = self.opt = self.sched = None

    def check(self, limits: dict, tf32: bool = False) -> tuple:
        """(numbers, env-steps compared, env-steps rejected): the reference
        follows the set-up's updates from the seed and the window's last
        update from the program's state before it. `tf32` (the control)
        runs the reference's matrix products in TF32."""
        from mwbench.reference.fused import Layout

        dev, cfg = self.dev, self.cell.config
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            lay = Layout(cfg["benchmark"], self.n, program.goal_seed(self.seed), dev,
                         max_episode_steps=cfg["max_episode_steps"],
                         **cfg.get("benchmark_args", {}))
            return self._follow(lay, limits)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _replay(self, model, adam, gen, cap, limits, lay=None, env=None, first=None):
        """The reference's update on the program's trajectory `cap`: its
        policy samples, GAE and learner, from `model`, `adam` and `gen` as
        the program had them. With `lay` and `env` (the reference's state)
        it also steps the environment on the program's actions. Returns
        (gaps, numbers of the environment, slots rejected, env-steps)."""
        from mwbench.reference import ppo as rppo

        dev, p, n = self.dev, self.p, self.n
        obs = cap["obs"].to(dev)
        T = obs.shape[0]
        policy_gap, nums, bad, compared = 0.0, {}, 0, 0
        values, logps = [], []
        no_rows = torch.zeros(n, dtype=torch.long, device=dev)
        with torch.no_grad():
            for t in range(T):
                act, logp, value = rppo.policy_sample(model, obs[t], gen)
                policy_gap = max(policy_gap,
                                 compare.mixed_gap(cap["act"][t].to(dev), act),
                                 compare.mixed_gap(cap["logp"][t].to(dev), logp),
                                 compare.mixed_gap(cap["value"][t].to(dev), value))
                values.append(value)
                logps.append(logp)
                if env is not None:
                    env, out = lay.step(env, cap["act"][t].to(dev), no_rows)
                    nxt = obs[t + 1] if t + 1 < T else cap["last_obs"].to(dev)
                    got_out = {"obs": nxt, "reward": cap["reward"][t].to(dev),
                               "done": cap["done"][t].to(dev).bool()}
                    ref_out = {k: out[k] for k in ("obs", "reward", "done")}
                    s, b = compare.step_numbers({}, got_out, {}, ref_out, limits)
                    nums = compare.merge(nums, s)
                    bad += b
                    compared += n
            last_value = model(cap["last_obs"].to(dev))[2]
            adv, ret = rppo.gae(cap["reward"].to(dev), torch.stack(values),
                                cap["done"].to(dev), last_value,
                                float(p["gamma"]), float(p["lam"]))
        gae_gap = max(compare.mixed_gap(cap["last_value"].to(dev), last_value),
                      compare.mixed_gap(cap["adv"].to(dev), adv),
                      compare.mixed_gap(cap["ret"].to(dev), ret))
        flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
        loss = rppo.learn(model, adam, flat(obs), flat(cap["act"].to(dev)),
                          flat(torch.stack(logps)), flat(adv), flat(ret),
                          int(p["epochs"]), int(p["minibatches"]), float(p["clip"]),
                          gen, first_grads=first)
        loss_gap = abs(cap["loss"] - float(loss)) / abs(float(loss))
        gaps = {"policy_gap": policy_gap, "gae_gap": gae_gap, "loss_gap_any_update": loss_gap}
        return gaps, nums, bad, compared

    def _follow(self, lay, limits):
        from mwbench.reference import ppo as rppo
        from mwbench.reference.fused import state_from_tree

        dev, p, n = self.dev, self.p, self.n
        flat0, obs0 = self.start
        got0 = state_from_tree(compare.unflatten(flat0, dev))
        # the start: the program's reset onto rows of its own goal tables
        rows, unmatched = lay.match_rows(got0.env.rand_vec,
                                         torch.ones(n, dtype=torch.bool, device=dev))
        env, ref_obs = lay.reset_state(rows)
        nums, bad = compare.step_numbers(got0, {"obs": obs0.to(dev)}, env,
                                         {"obs": ref_obs}, limits)
        nums["reset_unmatched"] = float(unmatched)
        compared = n
        model = rppo.ActorCritic(obs0.shape[1], int(p["hidden"])).to(dev)
        with torch.no_grad():
            for name, prm in model.named_parameters():
                prm.copy_(self.theta0[name])
        total = int(p["schedule_updates"]) * int(p["epochs"]) * int(p["minibatches"])
        adam = rppo.Adam(model.parameters(), float(p["lr"]), total)
        gen = program.generator(dev, self.seed, 6)
        gaps, first = {}, []
        for u, cap in enumerate(self.captures):
            g, s, b, c = self._replay(model, adam, gen, cap, limits,
                                      lay=lay if u == 0 else None,
                                      env=env if u == 0 else None,
                                      first=first if u == 0 else None)
            if u == 0:
                # the first update's loss: its first minibatches agree to the
                # bit, and Adam's rounding has had few steps to spread; a
                # later update's loss moves with any large minibatch loss
                loss_gap = g["loss_gap_any_update"]
            gaps = compare.merge(gaps, g)
            nums = compare.merge(nums, s)
            bad, compared = bad + b, compared + c
        names = self.names
        g_ref = dict(zip(names, first))
        g_got = {nm: (m / 0.1).to(dev) for nm, m in self.first_moment.items()}
        grad_gap = compare.leaf_norm_gap(g_got, g_ref)
        norms = {nm: float(g.double().norm()) for nm, g in g_ref.items()}
        med = sorted(norms.values())[len(norms) // 2]
        moved = {nm for nm, v in norms.items() if v >= 1e-3 * med}
        d_ref = {nm: prm.detach() - self.theta0[nm] for nm, prm in model.named_parameters()}
        d_got = {nm: self.theta_after[nm].to(dev) - self.theta0[nm] for nm in names}
        change_gap = compare.leaf_norm_gap(d_got, d_ref, keep=moved)
        # the window's last update, from the program's state before it
        pre = {k: self.before_last.part(k, dev) for k in ("theta", "m", "v")}
        with torch.no_grad():
            for name, prm in model.named_parameters():
                prm.copy_(pre["theta"][name])
        adam = rppo.Adam(model.parameters(), float(p["lr"]), total)
        adam.m = [pre["m"][nm].clone() for nm in names]
        adam.v = [pre["v"][nm].clone() for nm in names]
        adam.k = self.last_k
        gen = torch.Generator(device=dev)
        gen.set_state(self.last_gen)
        g, _, _, _ = self._replay(model, adam, gen, self.last, limits)
        gaps = compare.merge(gaps, g)
        d_ref = {nm: prm.detach() - pre["theta"][nm] for nm, prm in model.named_parameters()}
        d_got = {nm: self.theta_last[nm].to(dev) - pre["theta"][nm] for nm in names}
        change_gap = max(change_gap, compare.leaf_norm_gap(d_got, d_ref, keep=moved))
        nums.update(gaps, loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap)
        self.unmoved_leaves = sorted(set(names) - moved)
        return nums, compared, bad


KINDS = {"rollout": Rollout, "ppo": PPO}


def make(cell, seed: int, dev, trace: bool):
    return KINDS[cell.traffic["kind"]](cell, seed, dev, trace)
