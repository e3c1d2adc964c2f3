"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each wrapper calls its torch op ``fp8tpu::<name>`` (ops/kernels/library.py,
``<name>`` its key in ``WRAPPERS``), which takes the plain version for CPU
tensors and launches the CUDA kernel for CUDA tensors (no fallback between
the two); each wrapper counts its launches in its ``launches`` attribute
(``fused_quant_matmul_int8`` those of its s8 input branch also in
``s8_launches``).
"""

from fp8_quantization_tpu_torch.ops.kernels.attention import flash_mha
from fp8_quantization_tpu_torch.ops.kernels.qblock import (
    fused_inverted_residual)
from fp8_quantization_tpu_torch.ops.kernels.qconv import fused_quant_conv3x3
from fp8_quantization_tpu_torch.ops.kernels.qconv_int8 import (
    fused_quant_conv3x3_int8)
from fp8_quantization_tpu_torch.ops.kernels.qdwconv import (
    fused_quant_dwconv3x3)
from fp8_quantization_tpu_torch.ops.kernels.qmatmul import fused_quant_matmul
from fp8_quantization_tpu_torch.ops.kernels.qmatmul_int8 import (
    fused_quant_matmul_int8)
from fp8_quantization_tpu_torch.ops.kernels.qstem import fused_quant_stem
from fp8_quantization_tpu_torch.ops.kernels import library  # noqa: F401,E402

WRAPPERS = {"qstem": fused_quant_stem, "qconv3x3": fused_quant_conv3x3,
            "qmatmul": fused_quant_matmul,
            "qconv3x3_int8": fused_quant_conv3x3_int8,
            "qmatmul_int8": fused_quant_matmul_int8,
            "qdwconv3x3": fused_quant_dwconv3x3,
            "qblock": fused_inverted_residual, "flash_mha": flash_mha}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    fused_quant_matmul_int8.s8_launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
