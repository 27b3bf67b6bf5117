"""Hand-written CUDA kernels for Hopper: sources in `dwcgan_tpu_torch/csrc/`,
built by `build.py`, bound by `kernels.py`."""
