"""PyTorch/CUDA port of ``fp8_quantization_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; every module here names
the JAX module it mirrors.  Activations are NHWC at every public function
(as in the JAX package), weights are torch's OIHW / (out, in) and the
per-channel axis of a weight quantizer is dim 0.

Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``; there the kernel wrappers take their plain PyTorch
versions because the tensors they get lie on the CPU.
"""

from fp8_quantization_tpu_torch.device import resolve_device  # noqa: F401
