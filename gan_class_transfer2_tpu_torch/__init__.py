"""gan_class_transfer2_tpu_torch — the PyTorch/CUDA port of gan_class_transfer2_tpu.

The JAX package beside it stays the reference: every module here mirrors the
module of the same path there and is tested against it on the same inputs.
Public functions keep the JAX package's NHWC activations and HWIO kernels.
The port imports torch and numpy, never jax and never the JAX package.

Ported so far: sampling and editing, diffusion and cycle-GAN training
behind the ``train``, ``gan-train``, ``bench`` and ``profile`` commands, the
native C++ data loader and its cache, and FID/KID eval, with the JAX
package's four TPU kernels as hand-written CUDA (``csrc/``). ROADMAP.md
lists what is still missing.
"""

from .config import Config, tiny_test_config

__version__ = "0.1.0"
__all__ = ["Config", "tiny_test_config", "__version__"]
