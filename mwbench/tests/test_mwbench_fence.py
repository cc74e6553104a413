"""The fence: no module a run loads is JAX's, jaxlib's, flax's or the JAX
package's (top-level names compared whole), and the reference imports only
itself, torch, numpy and the standard library."""

from __future__ import annotations

import json
import subprocess
import sys

from mwbench import fence
from mwbench.cells import HERE

ROOT = HERE.parent


def test_reference_imports_only_itself():
    assert fence.reference_imports() == []


def test_top_level_names_compared_whole():
    mods = {"metaworld_tpu_torch": 0, "metaworld_tpu_torch.vector": 0, "torch": 0,
            "jaxtyping": 0, "flaxen": 0}
    assert fence.loaded_banned(mods) == []
    mods.update({"jax.numpy": 0, "metaworld_tpu.envs": 0, "flax": 0, "jaxlib": 0})
    assert fence.loaded_banned(mods) == ["flax", "jax.numpy", "jaxlib", "metaworld_tpu.envs"]


def _modules_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    mods = _modules_after(
        "from mwbench import run, traffic, trace, control, compare\n"
        "from mwbench.reference import fused, ppo\n"
        "from metaworld_tpu_torch import train_ppo, vector, bench\n"
        "from mwbench.tests.test_mwbench_harness import run_small\n"
        "run_small('mt10.rollout', 3)")
    assert fence.loaded_banned(dict.fromkeys(mods)) == []


def test_reference_loads_no_program():
    mods = _modules_after("from mwbench.reference import fused, ppo\n"
                          "fused.Layout('MT10', 10, 1, 'cpu')")
    assert not [m for m in mods if fence.top(m) in fence.BANNED | {"metaworld_tpu_torch"}]
