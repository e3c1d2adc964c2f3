"""The plain reference's quantizer arithmetic and datapath, in float32.

A frozen copy of the fixed FP8 fake-quant that the configurations name
(signed, 8 bits, M mantissa bits, a ``maxval`` per tensor or per output
channel): clip to [-maxval, maxval], read the binade from the float32
exponent field, round half to even on that binade's grid of M bits, scale
back.  The grid is the paper's: with E = 7 - M exponent bits, the top
binade ends at ``maxval`` and the binades below end at the subnormal
region, whose step is the lowest binade's.

``Quant`` holds what calibration sets: the weights' per-channel ranges
(``current_minmax``: each output channel's largest magnitude) and the
activations' per-tensor ranges (``allminmax`` over the calibration
batches: the largest magnitude seen).  In calibration a quantizer first
takes its range from the tensor, then quantizes it, so deeper layers
calibrate on what the shallower layers' new ranges give.

``Quant.operand`` is the datapath of every product: on ``bf16`` an
operand off a quantizer's grid (an image, an attention operand) is rounded
to bfloat16, an operand on its grid is exact there and stays as it is;
during calibration every activation operand of a conv or linear is
rounded, as a forward on fake-quantized values in bfloat16 rounds them,
and the attention's products stay float32, as the calibration forward
computes them; products are summed in float32 with TF32 off.  ``e4m3`` is the control: every operand, on a
grid or not, is scaled by its largest magnitude over 448 (per tensor for
activations, per output channel for weights) and cast to
``torch.float8_e4m3fn``, as a product on Hopper's FP8 tensor cores takes
it.  With ``wide`` the products are summed in float64 and rounded to
float32 once: the same reference but for the rounding of its sums, which
sets the floor that a sound program's own rounding reaches.

This module imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

DATAPATHS = ("bf16", "e4m3")
E4M3_MAX = 448.0


def _floor_log2(y: torch.Tensor) -> torch.Tensor:
    """floor(log2(y)) of positive float32 ``y`` from its exponent field."""
    return (((y.view(torch.int32) >> 23) & 0xFF) - 127).to(torch.float32)


def _exp2_int(k: torch.Tensor) -> torch.Tensor:
    """2**k for integer-valued float32 ``k``, exactly."""
    ki = torch.clamp(k, -126.0, 127.0).to(torch.int32)
    return ((ki + 127) << 23).view(torch.float32)


def fp8_fake_quant(x: torch.Tensor, maxval: torch.Tensor, mbits: int = 4,
                   n_bits: int = 8) -> torch.Tensor:
    """``x`` (float32) on the signed FP8 grid of ``maxval`` (broadcasting
    against ``x``) with ``mbits`` mantissa bits."""
    maxval = maxval.to(torch.float32)
    m = torch.tensor(float(mbits), dtype=torch.float32, device=x.device)
    two_pow_e = 2.0 ** (float(n_bits) - 1.0 - m)
    grid_top = 2.0 - 2.0 ** (-m)
    bias = two_pow_e - torch.log2(maxval) + torch.log2(grid_top) - 1.0
    bias_int = torch.floor(bias)
    bias_frac = torch.exp2(bias - bias_int)
    g = -m - two_pow_e + 1.0
    factor = maxval / grid_top
    xc = torch.minimum(torch.maximum(x, -maxval), maxval)
    binade = torch.clamp(_floor_log2(torch.abs(xc) * bias_frac) + bias_int,
                         min=1.0)
    pow2 = _exp2_int(binade + g)
    return torch.round(xc / (pow2 * factor)) * (pow2 * factor)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _e4m3(t: torch.Tensor, channel_dim=None) -> torch.Tensor:
    """``t`` through float8_e4m3fn at the scale of its largest magnitude
    (per tensor, or per slice along ``channel_dim``)."""
    if channel_dim is None:
        amax = t.abs().amax()
    else:
        dims = [d for d in range(t.ndim) if d != channel_dim]
        amax = t.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@contextlib.contextmanager
def float32_products():
    """Float32 matmuls and convolutions with TF32 off, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Quant:
    """The quantizers of one reference model: ranges by name, the mode
    (``calibrate`` or fixed) and the datapath of its products."""

    def __init__(self, mbits: int = 4, datapath: str = "bf16",
                 wide: bool = False):
        if datapath not in DATAPATHS:
            raise ValueError(f"datapath must be one of {DATAPATHS}, got "
                             f"{datapath!r}")
        self.mbits, self.datapath = mbits, datapath
        self.sums = torch.float64 if wide else torch.float32
        self.calibrating = False
        self.act_max: dict = {}
        self._weights: dict = {}

    def act(self, name: str, y: torch.Tensor, update: bool = True):
        """The output quant ``name`` of ``y`` (per tensor); in calibration
        its range is first widened to ``y``'s (``update``)."""
        if self.calibrating and update:
            seen = torch.maximum(y.amin().abs(), y.amax()).abs()
            old = self.act_max.get(name)
            self.act_max[name] = seen if old is None else torch.maximum(old, seen)
        return fp8_fake_quant(y, self.act_max[name], self.mbits)

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """The weight ``w`` on its per-output-channel (dim 0) grid: its
        range is its own (``current_minmax``), so the baked weight is the
        calibrated one."""
        if name not in self._weights:
            flat = w.reshape(w.shape[0], -1)
            maxval = torch.maximum(flat.amin(dim=1).abs(), flat.amax(dim=1)).abs()
            shape = (-1,) + (1,) * (w.ndim - 1)
            self._weights[name] = fp8_fake_quant(w, maxval.reshape(shape),
                                                 self.mbits)
        return self._weights[name]

    def operand(self, t: torch.Tensor, on_grid: bool = False,
                channel_dim=None, attention: bool = False) -> torch.Tensor:
        """A product's operand as the datapath holds it (module docstring);
        ``on_grid``: ``t`` is a quantizer's output (or a weight);
        ``channel_dim``: a weight's output channels, for the control's
        scale; ``attention``: an operand of the attention's two products,
        which the calibration forward keeps in float32."""
        if self.datapath == "e4m3":
            return _e4m3(t, channel_dim)
        if attention and self.calibrating:
            return t
        if on_grid and not (self.calibrating and channel_dim is None):
            return t
        return _bf16(t)

    def conv2d(self, x, w, **kw):
        """A conv of two operands as the datapath holds them (NCHW)."""
        return F.conv2d(x.to(self.sums), w.to(self.sums), **kw).to(torch.float32)

    def matmul(self, a, b):
        """A product of two operands as the datapath holds them."""
        return (a.to(self.sums) @ b.to(self.sums)).to(torch.float32)
