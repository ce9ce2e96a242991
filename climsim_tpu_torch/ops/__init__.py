"""Hand-written CUDA kernels (``csrc``) with their plain PyTorch versions.

Importing the package registers the kernels that an exported program
(``online.wrapper.export_aot``) calls as operators of torch.library
(namespace ``climsim_tpu_torch``); it builds nothing."""

from . import kernels, unet_fused  # noqa: F401  (registers the operators)
