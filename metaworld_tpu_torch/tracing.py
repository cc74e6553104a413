"""Spans at the port's layer boundaries: the fused step and its physics, the
engine's constructor, the kernel library's load and the PPO loop.

    with tracing.span("step.tails"):
        ...

A span costs one check of a module flag and one of the profiler when
nothing is on. While a `torch.profiler` records, a span also enters
`torch.profiler.record_function(name)`, so the program's layers label the
profiler's trace (a `user_annotation` event per span). Between `enable()`
and `take()` each span also keeps a record `Span(name, parent, start_ns,
end_ns)` in memory: `parent` is the index of the enclosing record (-1 at the
top), the stamps come from `time.perf_counter_ns()`, which is the
profiler's clock up to one offset. At most `CAP` records are kept; the
spans after them are counted and dropped. Spans nest by the order they
open, so they are opened from one thread, as the port's layers are. A span
never synchronises and touches no device memory, so it may stand inside a
captured CUDA graph.

The names, by layer:

    step            vector.FusedBatchedEnvs.step
      step.graph      the replay of the engine's CUDA graph (the kernel's
                      engines): the layers below then ran only at capture
      step.physics    the control step: physics.weld, physics.pack,
                      physics.launch, physics.unpack (the CUDA kernel) or
                      physics.plain (the plain PyTorch version)
      step.guard      the non-finite guard
      step.tails      every task group's observation and reward tail
      step.autoreset  NEXT_STEP autoreset
    physics.load    building or loading the kernel library (first launch)
    engine.build    vector.FusedBatchedEnvs.__init__: engine.scene_table,
                    engine.block_table, engine.reset_table, engine.graph
                    (the kernel's engines: one eager step and the capture
                    of the step, each with the step's layers above)
    ppo.rollout     train_ppo.rollout, with ppo.policy (policy_sample)
    ppo.gae         train_ppo.gae
    ppo.learn       train_ppo.learn, with ppo.minibatch (loss and Adam step)
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

CAP = 1 << 20  # records kept between enable() and take()


class Span(NamedTuple):
    name: str
    parent: int    # index of the enclosing record in the same list; -1: none
    start_ns: int  # time.perf_counter_ns()
    end_ns: int


_on = False
_records: list = []   # [name, parent, start_ns, end_ns] lists
_open: list = []      # indices of the records still open, innermost last
_dropped = 0
_NULL = contextlib.nullcontext()


class _Recorded:
    __slots__ = ("name", "rec", "label")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _dropped
        self.label = None
        if torch.autograd._profiler_enabled():
            self.label = torch.profiler.record_function(self.name)
            self.label.__enter__()
        records = _records
        if len(records) < CAP:
            self.rec = [self.name, _open[-1] if _open else -1,
                        time.perf_counter_ns(), 0]
            _open.append(len(records))
            records.append(self.rec)
        else:
            self.rec = None
            _dropped += 1
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec[3] = time.perf_counter_ns()
            # a take() inside the span has started a new list
            if _open and _records[_open[-1]] is self.rec:
                _open.pop()
        if self.label is not None:
            self.label.__exit__(*exc)
        return False


def span(name: str):
    """A context manager for the layer `name` (see the module's list)."""
    if _on:
        return _Recorded(name)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def enable():
    """Keep the records of the spans from now on, from an empty buffer."""
    global _on, _records, _open, _dropped
    _records, _open, _dropped = [], [], 0
    _on = True


def take() -> tuple[list[Span], int]:
    """Stop keeping records; return (the records in the order the spans
    started, the number dropped over the cap) and clear them. A span still
    open at the call reads an end of 0."""
    global _on, _records, _open, _dropped
    out, dropped = [Span(*r) for r in _records], _dropped
    _on, _records, _open, _dropped = False, [], [], 0
    return out, dropped


def self_ns(records: list[Span]) -> list[int]:
    """Each record's self time: its duration less its children's."""
    out = [r.end_ns - r.start_ns for r in records]
    for r in records:
        if r.parent >= 0:
            out[r.parent] -= r.end_ns - r.start_ns
    return out
