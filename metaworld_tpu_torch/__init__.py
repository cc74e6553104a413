"""metaworld_tpu_torch: the PyTorch/CUDA port of metaworld_tpu.

The fused multi-task step (`vector.FusedBatchedEnvs`) runs on an NVIDIA
GPU, with the physics control step in a hand-written CUDA kernel
(`physics/cuda_step.py`, `csrc/`). Entry points default to
`device="cuda"`; pass `device="cpu"` to run the plain PyTorch versions.

    import metaworld_tpu_torch as mw
    envs = mw.make_mt_envs("MT10", seed=42, terminate_on_success=True)
    agent = mw.evaluation.ScriptedAgent(envs)
    mean_success, *_ = mw.evaluation.evaluation(agent, envs, num_episodes=1)
    env = mw.SawyerEnv("reach-v3", seed=1)    # single-env Gymnasium API
"""

from metaworld_tpu_torch.benchmarks import (  # noqa: F401
    ML1,
    ML10,
    ML25,
    ML45,
    MT1,
    MT10,
    MT25,
    MT50,
    Benchmark,
    CustomML,
    Task,
)
from metaworld_tpu_torch import evaluation, parallel, vector, wrappers  # noqa: F401
from metaworld_tpu_torch.envs.registry import ALL_V3_ENVIRONMENTS  # noqa: F401
from metaworld_tpu_torch.gym_adapter import (  # noqa: F401
    SawyerEnv,
    make_goal_hidden,
    make_goal_observable,
    make_ml_envs,
    make_ml_envs_test,
    make_ml_envs_train,
    make_mt_envs,
    register_mw_envs,
)

__version__ = "0.1.0"
