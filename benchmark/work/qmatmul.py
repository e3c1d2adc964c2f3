"""Work of the FP8 quant-matmul, ``y = epilogue(q(x) @ q(w)^T)``.

Counted from the call's arguments, whatever the implementation: x (M, K)
read once at its dtype, w (N, K) read once at its dtype, the (N,) scale
and shift and the quantizers' constants read once, y (M, N) written once
(bfloat16 when the call emits a normalized output, else float32); 2 M N K
operations on the bf16 datapath (the operands are exact in bf16).
"""

WRAPPER = ("fp8_quantization_tpu_torch.ops.kernels.qmatmul", "fused_quant_matmul")
KERNELS = ("qmatmul_kernel",)


def _nbytes(t):
    return 0 if t is None else t.numel() * t.element_size()


def work(args, kwargs):
    """(bytes, operations, datapath) of one call."""
    x, w, w_consts, a_consts, scale, shift = args[:6]
    cfg = kwargs["cfg"]
    m, k = x.shape
    n = w.shape[0]
    out = m * n * (2 if cfg.emit_norm else 4)
    moved = (_nbytes(x) + _nbytes(w) + _nbytes(w_consts) + _nbytes(a_consts)
             + _nbytes(scale) + _nbytes(shift) + out)
    return moved, 2 * m * n * k, "bf16"
