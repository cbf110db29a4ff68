"""gan_class_transfer2_tpu_torch — the PyTorch/CUDA port of gan_class_transfer2_tpu.

The JAX package beside it stays the reference: every module here mirrors the
module of the same path there and is tested against it on the same inputs.
Public functions keep the JAX package's NHWC activations and HWIO kernels.
The port imports torch and numpy, never jax and never the JAX package.

Ported so far: the serving path — reverse-diffusion sampling and the
invert→edit→decode workflow — with the k4/s2 down conv as a hand-written CUDA
kernel (ops/fused_down_conv.py, csrc/down_conv.cu).
"""

from .config import Config, tiny_test_config

__version__ = "0.1.0"
__all__ = ["Config", "tiny_test_config", "__version__"]
