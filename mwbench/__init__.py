"""The benchmark of metaworld_tpu_torch on NVIDIA GPUs (see `run.py`)."""
