"""metaworld_tpu_torch: the PyTorch/CUDA port of metaworld_tpu.

The fused multi-task step (`vector.FusedBatchedEnvs`) runs on an NVIDIA
GPU, with the physics control step in a hand-written CUDA kernel
(`physics/cuda_step.py`, `csrc/`). Entry points default to
`device="cuda"`; pass `device="cpu"` to run the plain PyTorch versions.
"""
