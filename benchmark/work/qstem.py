"""Work of the FP8 ResNet stem: a 7x7 stride-2 conv with padding 3, its
scale, shift and relu, a 3x3 stride-2 max pool with padding 1 and the
output quant.

Counted from the call's arguments, whatever the implementation: the images
x (N, S, S, Cin) read once at their dtype, the weight matrix w (Kp, Cout)
once, the (Cout,) scale and shift and the output quantizer's constants
once, y (N, P, P, Cout) written once (bfloat16 when the call emits a
normalized output, else float32), with C = (S - 1) // 2 + 1 the conv's
and P = (C - 1) // 2 + 1 the pool's side; 2 N C C 49 Cin Cout operations
on the bf16 datapath (the pool's comparisons are not counted).
"""

WRAPPER = ("fp8_quantization_tpu_torch.ops.kernels.qstem", "fused_quant_stem")
KERNELS = ("qstem_kernel",)


def _nbytes(t):
    return 0 if t is None else t.numel() * t.element_size()


def work(args, kwargs):
    """(bytes, operations, datapath) of one call."""
    x, w, a_consts, scale, shift = args[:5]
    cfg = kwargs["cfg"]
    n, s, _, cin = x.shape
    cout = w.shape[1]
    conv = (s - 1) // 2 + 1
    pool = (conv - 1) // 2 + 1
    out = n * pool * pool * cout * (2 if cfg.emit_norm else 4)
    moved = (_nbytes(x) + _nbytes(w) + _nbytes(a_consts) + _nbytes(scale)
             + _nbytes(shift) + out)
    return moved, 2 * n * conv * conv * 49 * cin * cout, "bf16"
