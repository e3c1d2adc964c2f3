"""Helpers shared by the kernel wrappers (no JAX counterpart)."""

from __future__ import annotations

import contextlib

import torch

ACTIVATION_CODES = {None: 0, "relu": 1, "relu6": 2}   # csrc/fq_epilogue.cuh


def int_grid_unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the integer grids of the FP8/bf16 kernel bodies are not "
        "ported yet (ROADMAP.md, section B, item 9); the int8 datapath has "
        "its own kernels (qmatmul_int8, qconv_int8)")


def check_methods(act_method: str, activation, weight_method: str = "none"):
    if weight_method not in ("fp8", "none"):
        raise int_grid_unported(f"weight_method={weight_method!r}")
    if act_method not in ("fp8", "none"):
        raise int_grid_unported(f"act_method={act_method!r}")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"fused kernels take activation None, 'relu' or "
                         f"'relu6', not {activation!r}")


@contextlib.contextmanager
def no_tf32():
    """Full-precision float32 products for the plain versions on the card
    (cuDNN convolutions default to TF32); restores the flags after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def on_card(*tensors: torch.Tensor) -> bool:
    """True when the operands lie on the card (launch the kernel), False
    when they lie on the CPU (take the plain version); raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"kernel operands must all lie on one CUDA device or "
                     f"all on the CPU, got {sorted(str(t.device) for t in tensors)}")


def require(t: torch.Tensor, name: str, dtypes, shape=None,
            vector_loads: bool = False) -> None:
    """Raise unless ``t`` is contiguous, of one of ``dtypes`` and ``shape``;
    with ``vector_loads`` (a kernel reads it 16 bytes at a time) its data
    must also start on a 16-byte boundary."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if vector_loads and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def consts_or_dummy(c, like: torch.Tensor) -> torch.Tensor:
    """A (6, C) fp8 constant tensor, or a zero (6, 1) one when unused."""
    if c is None:
        return torch.zeros((6, 1), dtype=torch.float32, device=like.device)
    return c


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
