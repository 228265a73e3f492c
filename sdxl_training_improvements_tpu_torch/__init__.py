"""PyTorch/CUDA port of the SDXL framework for one NVIDIA H100.

The JAX package ``sdxl_training_improvements_tpu`` is the reference this
port is held against; nothing here imports it, JAX, flax or yaml.
"""
