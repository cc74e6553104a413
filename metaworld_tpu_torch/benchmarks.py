"""Benchmark construction (numpy), copied from the JAX package's
`benchmarks.py`: MT1/MT10/MT25/MT50, ML1/ML10/ML25/ML45 and CustomML.

Reimplements the reference's Benchmark ABC and task generation
(ref metaworld/__init__.py:55-395, env_dict.py:217-465) with one key
architectural change: a "task" is not a pickled env blob but a row in a
device-resident goal table — `Benchmark.goal_table(name)` returns the
(n_goals, MAX_RAND) array the vectorized engine gathers from in-graph.

Goal sampling replays the reference's numpy semantics exactly
(ref _make_tasks :114-179): `np.random.seed(seed)`, envs consumed in split
order, each of the 50 resets drawing TWICE (the reference's reset() invokes
reset_model twice, ref sawyer_xyz_env.py:664-682) with per-task rejection
resampling — so the generated vectors are bit-identical to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from metaworld_tpu_torch.envs import registry
from metaworld_tpu_torch.envs.core import TaskSpec

_N_GOALS = 50

MT10_LIST = [
    "reach-v3", "push-v3", "pick-place-v3", "door-open-v3", "drawer-open-v3",
    "drawer-close-v3", "button-press-topdown-v3", "peg-insert-side-v3",
    "window-open-v3", "window-close-v3",
]

MT25_LIST = MT10_LIST + [
    "coffee-pull-v3", "pick-out-of-hole-v3", "disassemble-v3",
    "pick-place-wall-v3", "basketball-v3", "stick-pull-v3",
    "button-press-wall-v3", "faucet-open-v3", "door-lock-v3", "lever-pull-v3",
    "sweep-into-v3", "faucet-close-v3", "coffee-button-v3",
    "button-press-topdown-wall-v3", "dial-turn-v3",
]

MT50_LIST = registry.ALL_V3_ENVIRONMENTS

ML10_TRAIN = [
    "reach-v3", "push-v3", "pick-place-v3", "door-open-v3", "drawer-close-v3",
    "button-press-topdown-v3", "peg-insert-side-v3", "window-open-v3",
    "sweep-v3", "basketball-v3",
]
ML10_TEST = [
    "drawer-open-v3", "door-close-v3", "shelf-place-v3", "sweep-into-v3",
    "lever-pull-v3",
]

ML25_TRAIN = MT25_LIST
ML25_TEST = [
    "basketball-v3", "door-close-v3", "shelf-place-v3", "sweep-v3",
    "button-press-v3",
]

ML45_TEST = [
    "bin-picking-v3", "box-close-v3", "hand-insert-v3", "door-lock-v3",
    "door-unlock-v3",
]
ML45_TRAIN = [n for n in MT50_LIST if n not in ML45_TEST]

# Rejection-resampling conditions per task (the reference's `while bad:
# resample` loops in each reset_model; see e.g. sawyer_reach_v3.py:127-129).
# value = minimum separation between v[:2] and v[3:5]; callables for special
# cases.
_REJECT_SEP = {
    "reach-v3": 0.15, "reach-wall-v3": 0.15, "push-v3": 0.15,
    "pick-place-v3": 0.15,
    "push-wall-v3": 0.15, "pick-place-wall-v3": 0.15, "push-back-v3": 0.15,
    "soccer-v3": 0.15, "coffee-pull-v3": 0.15, "coffee-push-v3": 0.15,
    "hand-insert-v3": 0.15, "pick-out-of-hole-v3": 0.15, "basketball-v3": 0.15,
    "peg-insert-side-v3": 0.1, "assembly-v3": 0.1, "disassemble-v3": 0.1,
    "stick-push-v3": 0.1, "stick-pull-v3": 0.1, "shelf-place-v3": 0.1,
    "box-close-v3": 0.25,
}


def _rejects(name: str, v: np.ndarray) -> bool:
    if name == "sweep-into-v3":
        return np.linalg.norm(v[:2] - np.array([0.0, 0.84])) < 0.15
    sep = _REJECT_SEP.get(name)
    if sep is None or v.shape[0] < 5:
        return False
    return np.linalg.norm(v[:2] - v[3:5]) < sep


class Task(NamedTuple):
    """MDP descriptor (ref metaworld/types.py:10-17). Instead of opaque
    pickled bytes, the payload is the raw goal vector + observability."""

    env_name: str
    rand_vec: np.ndarray
    partially_observable: bool


def _draw(spec: TaskSpec, name: str, rng=np.random) -> np.ndarray:
    """One reset_model draw with the task's rejection loop. `rng` is the
    global numpy module (benchmark construction, ref _make_tasks) or a
    Generator (a seeded env's np_random stream, ref sawyer_xyz_env.py:
    703-710 — gymnasium's seeding.np_random(seed) is bit-identical to
    np.random.default_rng(seed))."""
    v = rng.uniform(spec.rand_low, spec.rand_high,
                    size=spec.rand_low.size).astype(np.float64)
    while _rejects(name, v):
        v = rng.uniform(spec.rand_low, spec.rand_high,
                        size=spec.rand_low.size).astype(np.float64)
    return v


def _make_tasks(env_names: list[str], seed: int | None,
                partially_observable: bool, n_goals: int = _N_GOALS):
    """Replay of ref metaworld/__init__.py:114-179 (global-numpy variant)."""
    if seed is not None:
        st = np.random.get_state()
        np.random.seed(seed)
    tasks: list[Task] = []
    try:
        for name in env_names:
            spec = registry.get_spec(name)
            vecs = []
            for _ in range(n_goals):
                _draw(spec, name)          # first reset_model call (discarded)
                vecs.append(_draw(spec, name))  # second call wins
            uniq = {tuple(np.round(v, 12)) for v in vecs}
            assert len(uniq) == n_goals, f"{name}: non-unique goal vectors"
            tasks.extend(
                Task(name, v, partially_observable) for v in vecs
            )
    finally:
        if seed is not None:
            np.random.set_state(st)
    return tasks


@dataclasses.dataclass
class Benchmark:
    """Train/test task sets (ref Benchmark ABC, metaworld/__init__.py:55-88)."""

    train_classes: dict[str, TaskSpec]
    test_classes: dict[str, TaskSpec]
    train_tasks: list[Task]
    test_tasks: list[Task]

    def goal_table(self, name: str, split: str = "train") -> np.ndarray:
        """(n_goals, MAX_RAND) goal vectors for one env — the device table
        the vector engine samples from."""
        from metaworld_tpu_torch.types import MAX_RAND

        tasks = self.train_tasks if split == "train" else self.test_tasks
        vecs = [t.rand_vec for t in tasks if t.env_name == name]
        out = np.zeros((len(vecs), MAX_RAND))
        for i, v in enumerate(vecs):
            out[i, : v.shape[0]] = v
        return out


def _specs(names: list[str]) -> dict[str, TaskSpec]:
    return {n: registry.get_spec(n) for n in names}


def MT1(env_name: str, seed: int | None = None,
        num_goals: int = _N_GOALS) -> Benchmark:
    """(ref metaworld/__init__.py:185-206; num_goals mirrors the
    registration-time kwarg that mutates _N_GOALS, ref :618-621)"""
    assert env_name in registry.TASK_ID, f"unknown env {env_name}"
    return Benchmark(
        train_classes=_specs([env_name]),
        test_classes={},
        train_tasks=_make_tasks([env_name], seed, partially_observable=False,
                                n_goals=num_goals),
        test_tasks=[],
    )


def _mt(names: list[str], seed=None, num_goals: int = _N_GOALS) -> Benchmark:
    return Benchmark(
        train_classes=_specs(names),
        test_classes={},
        train_tasks=_make_tasks(names, seed, partially_observable=False,
                                n_goals=num_goals),
        test_tasks=[],
    )


def MT10(seed: int | None = None, num_goals: int = _N_GOALS) -> Benchmark:
    return _mt(MT10_LIST, seed, num_goals)


def MT25(seed: int | None = None, num_goals: int = _N_GOALS) -> Benchmark:
    return _mt(MT25_LIST, seed, num_goals)


def MT50(seed: int | None = None, num_goals: int = _N_GOALS) -> Benchmark:
    return _mt(MT50_LIST, seed, num_goals)


def ML1(env_name: str, seed: int | None = None,
        num_goals: int = _N_GOALS) -> Benchmark:
    """Meta-RL on one env: train and test goals from disjoint seeds
    (ref :271-299 — test seed = seed + 1)."""
    assert env_name in registry.TASK_ID, f"unknown env {env_name}"
    return Benchmark(
        train_classes=_specs([env_name]),
        test_classes=_specs([env_name]),
        train_tasks=_make_tasks([env_name], seed, partially_observable=True,
                                n_goals=num_goals),
        test_tasks=_make_tasks(
            [env_name], seed + 1 if seed is not None else None,
            partially_observable=True, n_goals=num_goals,
        ),
    )


def _ml(train: list[str], test: list[str], seed=None,
        num_goals: int = _N_GOALS) -> Benchmark:
    return Benchmark(
        train_classes=_specs(train),
        test_classes=_specs(test),
        train_tasks=_make_tasks(train, seed, partially_observable=True,
                                n_goals=num_goals),
        test_tasks=_make_tasks(test, seed, partially_observable=True,
                               n_goals=num_goals),
    )


def ML10(seed: int | None = None, num_goals: int = _N_GOALS) -> Benchmark:
    return _ml(ML10_TRAIN, ML10_TEST, seed, num_goals)


def ML25(seed: int | None = None, num_goals: int = _N_GOALS) -> Benchmark:
    return _ml(ML25_TRAIN, ML25_TEST, seed, num_goals)


def ML45(seed: int | None = None, num_goals: int = _N_GOALS) -> Benchmark:
    return _ml(ML45_TRAIN, ML45_TEST, seed, num_goals)


def CustomML(train_envs: list[str], test_envs: list[str],
             seed: int | None = None, num_goals: int = _N_GOALS) -> Benchmark:
    """(ref :370-395 — train and test sets must be disjoint)"""
    assert not set(train_envs) & set(test_envs), "train and test must not overlap"
    return _ml(train_envs, test_envs, seed, num_goals)
