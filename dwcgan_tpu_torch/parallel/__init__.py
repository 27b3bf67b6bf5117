"""Data-parallel training: the data axis of `dwcgan_tpu/parallel/mesh.py`."""
