"""FID/IS evaluation of the port (the counterpart of `dwcgan_tpu/eval/`)."""
