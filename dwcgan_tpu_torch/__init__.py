"""PyTorch/CUDA port of dwcgan_tpu for NVIDIA Hopper.

Imports torch and numpy only: never jax, flax or anything of `dwcgan_tpu`.
The norm ops run hand-written CUDA kernels on the card (`ops/cuda/`) and
their plain PyTorch versions on the CPU.
"""
