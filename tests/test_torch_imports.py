"""The port stands alone: no module of `metaworld_tpu_torch` imports JAX,
flax or the JAX package, and importing the port loads none of them."""

import ast
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "metaworld_tpu_torch"
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "metaworld_tpu")
MODULES = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_has_modules():
    names = {p.relative_to(PKG).as_posix() for p in MODULES}
    assert {"vector.py", "physics/cuda_step.py", "physics/engine_lanes.py",
            "envs/core.py", "convert.py", "policies/base.py",
            "evaluation.py", "wrappers.py", "gym_adapter.py", "render.py",
            "train_apg.py", "rewards/v1.py", "parallel/mesh.py",
            "parallel/sharded.py"} <= names
    tasks = [p for p in MODULES if p.parent == PKG / "envs" / "tasks"
             and p.name.endswith("_v3.py")]
    experts = [p for p in MODULES if p.parent == PKG / "policies"
               and p.name.startswith("impl_") and p.name.endswith("_v3.py")]
    assert len(tasks) == 50
    assert len(experts) == 50
    assert {p.name for p in experts} == {"impl_" + p.name for p in tasks}


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(PKG).as_posix())
def test_module_imports_no_jax(path):
    for name in _imported(ast.parse(path.read_text())):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import metaworld_tpu_torch.vector, metaworld_tpu_torch.convert\n"
        "import metaworld_tpu_torch.evaluation, metaworld_tpu_torch.wrappers\n"
        "from metaworld_tpu_torch.gym_adapter import make_mt_envs, SawyerEnv\n"
        "import metaworld_tpu_torch.render, metaworld_tpu_torch.train_apg\n"
        "import metaworld_tpu_torch.rewards.v1\n"
        "from metaworld_tpu_torch.parallel import ShardedEnvs, make_env_mesh\n"
        "from metaworld_tpu_torch.envs import registry\n"
        "assert all(registry.get_spec(n, 'v1') for n in registry.ALL_V3_ENVIRONMENTS)\n"
        "from metaworld_tpu_torch import register_mw_envs, make_goal_hidden\n"
        "envs = make_mt_envs('MT10', device='cpu', num_goals=2)\n"
        "assert envs.num_envs == 10 and envs.device.type == 'cpu'\n"
        "from metaworld_tpu_torch.policies import implemented_policies\n"
        "assert len(implemented_policies()) == 50\n"
        "import metaworld_tpu_torch.benchmarks as b\n"
        "b.MT10(seed=0, num_goals=2)\n"
        "b.MT25(seed=0, num_goals=2)\n"
        "b.MT50(seed=0, num_goals=2)\n"
        "b.ML45(seed=0, num_goals=2)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'metaworld_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_every_task_module_imports_with_jax_blocked():
    """With jax, jaxlib, flax and metaworld_tpu made unimportable, every one
    of the 50 task modules imports and builds its spec."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'metaworld_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from metaworld_tpu_torch.envs import registry\n"
        "specs = [registry.get_spec(n) for n in registry.ALL_V3_ENVIRONMENTS]\n"
        "assert len(specs) == 50\n"
        "print('imported', len(specs))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported 50" in res.stdout


def test_facade_runs_without_gymnasium():
    """Gymnasium is optional: with it made unimportable the port imports,
    SawyerEnv steps and renders, register_mw_envs does nothing, and no JAX
    module is loaded."""
    code = (
        "import sys\n"
        "for m in ('gymnasium', 'jax', 'jaxlib', 'flax', 'metaworld_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import metaworld_tpu_torch as mw\n"
        "env = mw.SawyerEnv('reach-v3', seed=1, device='cpu',\n"
        "                   render_mode='rgb_array', width=32, height=24)\n"
        "obs, _ = env.reset()\n"
        "obs, r, te, tr, info = env.step(np.zeros(4))\n"
        "assert obs.shape == (39,) and env.render().shape == (24, 32, 3)\n"
        "mw.register_mw_envs()\n"
        "print('no gym ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "no gym ok" in res.stdout
