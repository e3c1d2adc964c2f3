"""Work of the FP8 3x3 conv, ``y = epilogue(conv3x3(x, w) [+ residual])``,
padding 1.

Counted from the call's arguments, whatever the implementation: x
(N, H, W, Cin) read once at its dtype, w (Cout, 9 Cin) once, the (Cout,)
scale and shift, the output quantizer's constants and a residual once,
y (N, Ho, Wo, Cout) written once (bfloat16 when the call emits a
normalized output, else float32), Ho = (H - 1) // stride + 1; 2 N Ho Wo
9 Cin Cout operations on the bf16 datapath.
"""

WRAPPER = ("fp8_quantization_tpu_torch.ops.kernels.qconv", "fused_quant_conv3x3")
KERNELS = ("qconv3x3_kernel",)


def _nbytes(t):
    return 0 if t is None else t.numel() * t.element_size()


def work(args, kwargs):
    """(bytes, operations, datapath) of one call."""
    x, w, a_consts, scale, shift = args[:5]
    residual = args[5] if len(args) > 5 else kwargs.get("residual")
    cfg = kwargs["cfg"]
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    ho, wo = (h - 1) // cfg.stride + 1, (wd - 1) // cfg.stride + 1
    out = n * ho * wo * cout * (2 if cfg.emit_norm else 4)
    moved = (_nbytes(x) + _nbytes(w) + _nbytes(a_consts) + _nbytes(scale)
             + _nbytes(shift) + _nbytes(residual) + out)
    return moved, 2 * n * ho * wo * 9 * cin * cout, "bf16"
