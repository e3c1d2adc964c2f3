"""Work of the ViT's flash attention, ``softmax(q k^T * sm_scale) v`` over
(B, H, S, D) operands.

Counted from the call's arguments, whatever the implementation: q, k and v
read once at their dtype, the float32 (B, H, S, D) output written once;
4 B H S^2 D operations (the two products, q k^T and p v, 2 B H S^2 D
each) on the bf16 datapath (the operands are rounded to bf16).  The
softmax's exponentials, maxima and sums are not counted.
"""

WRAPPER = ("fp8_quantization_tpu_torch.ops.kernels.attention", "flash_mha")
KERNELS = ("flash_mha_kernel",)


def _nbytes(t):
    return t.numel() * t.element_size()


def work(args, kwargs):
    """(bytes, operations, datapath) of one call."""
    q, k, v = args[:3]
    b, h, s, d = q.shape
    moved = _nbytes(q) + _nbytes(k) + _nbytes(v) + 4 * q.numel()
    return moved, 4 * b * h * s * s * d, "bf16"
