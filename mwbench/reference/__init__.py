"""The plain reference that decides a run's `correct`.

Plain PyTorch in float32, run with TF32 off. It imports nothing of the
program under test, of the JAX package or of JAX: every module here is its
own frozen copy, and the benchmark hands it only the task names, the seed,
states and actions.

Frozen copies of metaworld_tpu_torch at commit 3742bce (each file's first
line names its source), with imports renamed to this package:

  types.py, benchmarks.py              <- types.py, benchmarks.py
  physics/engine.py, engine_lanes.py,  <- physics/ (the plain lane engine)
  maths.py, plain_step.py                 and cuda_step.py's lane layout,
                                          scene table and plain_control_step
  envs/core.py, registry.py,           <- envs/ (post_step, env_reset, the
  scene_builder.py, tasks/*.py            50 task modules of MT50)
  rewards/utils.py                     <- rewards/utils.py
  data/reach_envelope.npz              <- data/reach_envelope.npz
  devices.py                           <- devices.device_key

Written for the benchmark: `fused.py` (the fused step's order of layers as
`vector.FusedBatchedEnvs.step` runs them, with reset rows handed in) and
`ppo.py` (ActorCritic, the policy sample, GAE, the PPO loss, gradient
clipping and Adam, written out from `train_ppo.py` and torch.optim.Adam's
documented update).
"""
