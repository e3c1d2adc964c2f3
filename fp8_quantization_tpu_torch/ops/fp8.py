"""Simulated FP8 quantization on torch tensors.

Mirrors ``fp8_quantization_tpu/ops/fp8.py``: ``quantize_to_fp8`` with the
exact exponent read (``impl='bitcast'``, there lines 86-182), including
``normalized=True``; ``default_fp8_maxval``, ``fp8_set_quant_range`` and the
grid oracles ``generate_all_values_fp`` / ``generate_all_float_values_scaled``
/ ``get_max_value``.

FP8 quantization is INT quantization with per-element power-of-two scales
``2^(floor(log2|x|) + bias) - M - bias)`` derived from a (per-channel)
``maxval`` and a mantissa-bit count ``M``.  The bin is chosen by reading the
IEEE exponent field of ``|x| * 2^frac(bias)`` through an int32 view, never
by a transcendental ``log2`` (which can pick the wrong bin within an ulp of
a power of two).  Gradients w.r.t. ``x``, ``maxval`` and ``mantissa_bits``
follow the JAX package: the bin choice is detached and rounding takes the
gradient estimator of its discretizer (``ops/rounding``; straight-through
by default).

``fp8_consts`` / ``fp8_quantize_prepared`` freeze the scalar algebra of a
fixed quantizer into a ``(6, C)`` tensor that the CUDA kernels read (see
``csrc/fq_epilogue.cuh``); the per-element arithmetic is the same as
``quantize_to_fp8``'s, so both give identical values.

The deployment cast path (JAX lines 186-305): ``fp8_cast_consts`` /
``fp8_quantize_cast`` evaluate the fixed quantizer as a division by
``cast_scale = maxval / f8_max``, one saturating cast to the IEEE 1-byte
format with M mantissa bits and, below its smallest normal, a
magic-constant round; bit-exact against the exact pipeline, ties included.
The formats (``IEEE_F8``): E5M2 is ``torch.float8_e5m2``; E4M3 is stored
in ``torch.float8_e4m3fn``, whose grid below 240 is IEEE E4M3's, behind
the clip at +-240 (the constants are IEEE's: ``finfo(float8_e4m3fn).max``
is 448); E3M4 has no torch dtype, so it is rounded by exponent-field
arithmetic and stored as its IEEE codes (the bytes of JAX's
``float8_e3m4``) in ``torch.bits8``, a dtype that takes no arithmetic:
``ieee_decode`` is the only way back to numbers.  ``torch.export.save``
cannot serialize ``torch.bits8``, so while ``torch.export`` traces (the
serving export, serving/export.py) the same codes are stored in
``torch.uint8``, which ``ieee_decode`` reads alike.
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch

from fp8_quantization_tpu_torch.ops.rounding import Discretizer, round_ste


def generate_all_values_fp(num_total_bits: int = 8, num_exponent_bits: int = 4,
                           bias: int = 8) -> np.ndarray:
    """Every representable value of an EmMn format (signed, subnormals),
    sorted; the test oracle for the grid."""
    num_fraction_bits = num_total_bits - 1 - num_exponent_bits
    values = []
    for sign in (-1.0, 1.0):
        for e_bits in product(*[[0, 1]] * num_exponent_bits):
            e_enc = 0
            for b in e_bits:
                e_enc = 2 * e_enc + b
            is_subnormal = 1 if (e_enc - bias) == -bias else 0
            for f_bits in product(*[[0, 1]] * num_fraction_bits):
                f_enc = 0
                for b in f_bits:
                    f_enc = 2 * f_enc + b
                f_eff = f_enc * 2.0 ** -num_fraction_bits + 1 - is_subnormal
                values.append(sign * 2.0 ** (e_enc - bias + is_subnormal) * f_eff)
    return np.sort(np.array(values))


def generate_all_float_values_scaled(num_total_bits: int, num_exp_bits: int,
                                     exp_bias: int,
                                     range_limit_fp: float) -> np.ndarray:
    """The format's grid rescaled so that its largest magnitude is
    ``range_limit_fp``."""
    grid = generate_all_values_fp(num_total_bits, num_exp_bits, exp_bias)
    float_max_abs_val = np.max(np.abs(grid))
    return grid / (float_max_abs_val / range_limit_fp)


def get_max_value(num_exponent_bits: int = 4, bias: int = 8) -> float:
    """Largest representable magnitude of an 8-bit EmMn format."""
    num_fraction_bits = 7 - num_exponent_bits
    max_frac = 1.0 - 2.0 ** -num_fraction_bits
    return 2.0 ** (2 ** num_exponent_bits - 1 - bias) * (1.0 + max_frac)


def default_fp8_maxval(mantissa_bits: int, n_bits: int = 8) -> float:
    """Default signed maxval ``(2 - 2^-M) * 2^(2^E - 1 - 2^(E-1))``."""
    ebits = n_bits - mantissa_bits - 1
    default_bias = 2 ** (ebits - 1)
    return (2.0 - 2.0 ** -mantissa_bits) * 2.0 ** (2 ** ebits - 1 - default_bias)


def _floor_log2_exact(y: torch.Tensor) -> torch.Tensor:
    """floor(log2(y)) for positive finite float32 y from the exponent field;
    zero and subnormals give -127."""
    bits = y.view(torch.int32)
    return (((bits >> 23) & 0xFF) - 127).to(torch.float32)


def _exp2_int_exact(k: torch.Tensor) -> torch.Tensor:
    """2**k for integer-valued float k, clipped to [-126, 127], exactly."""
    ki = torch.clamp(k, -126.0, 127.0).to(torch.int32)
    return ((ki + 127) << 23).view(torch.float32)


def _clip_mbits(mantissa_bits, n_bits: int, sign_bits_f, discretizer):
    """M = clip(round(mantissa_bits), 1, n_bits - sign_bits), with jnp.clip's
    max-then-min gradient convention."""
    m = discretizer(mantissa_bits)
    return torch.minimum(torch.maximum(m, torch.ones_like(m)),
                         float(n_bits) - sign_bits_f)


_LN2 = float(np.float32(np.log(2.0)))


def _balanced(a: torch.Tensor, ans: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d max(a, b)/da (or min): 1 where ``a`` attains ``ans``, halved on a
    tie with ``b``; JAX's convention, which torch's max/min also follow."""
    return (a == ans).to(torch.float32) / torch.where(b == ans, 2.0, 1.0)


class _QuantizeToFP8(torch.autograd.Function):
    """FP8 fake-quant, rounding by a discretizer (``ops/rounding``).

    The backward is written out as the JAX package's autodiff computes it:
    the same operations in the same order (its quotient rule
    ``-((ct * y^-2) * x)``, ``log(2) * ct * ans`` for exp2 and pow, balanced
    max/min ties), with the discretizer's own backward on the rounding.
    torch's own autograd rounds some of these steps in other
    places, and the range-parameter gradients cancel nearly equal terms, so
    only this gives gradients w.r.t. x, maxval and mantissa_bits that are
    bit-exact per element.
    """

    @staticmethod
    def forward(ctx, x, maxval, mantissa_bits, sign_bits_f, n_bits: int,
                normalized: bool, disc):
        hi_m = float(n_bits) - sign_bits_f
        m_round = torch.round(mantissa_bits)
        m_lo = torch.maximum(torch.ones_like(m_round), m_round)
        M = torch.minimum(hi_m, m_lo)                  # clip(round(mb), 1, hi)
        two_pow_E = 2.0 ** (hi_m - M)
        two_pow_negM = 2.0 ** (-M)
        grid_top = 2.0 - two_pow_negM                  # 2 - 2^-M
        bias = two_pow_E - torch.log2(maxval) + torch.log2(grid_top) - 1.0

        minval = torch.where(sign_bits_f > 0, -maxval, torch.zeros_like(maxval))
        x_lo = torch.maximum(x, minval)
        xc = torch.minimum(x_lo, maxval)

        # floor(log2|xc| + bias) == floor(log2(|xc| * 2^frac(bias))) +
        # floor(bias): the fractional part of the bias folds into one
        # multiply and the exponent field is read directly.
        bias_int = torch.floor(bias)
        y = torch.abs(xc) * torch.exp2(bias - bias_int)
        log_scales = torch.clamp(_floor_log2_exact(y) + bias_int, min=1.0)

        # 2^(k - M - bias) == 2^(k - M - 2^E + 1) * maxval / (2 - 2^-M): the
        # power of two is built exactly; the reference multiplies it by
        # exp2(g - stop_gradient(g)), 1.0 in value, which carries d/dM.
        pow2 = _exp2_int_exact(log_scales + (-M - two_pow_E + 1.0))
        factor = maxval / grid_top
        scales = pow2 * factor
        m, ctx.disc_saved = disc.forward(xc / scales)
        ctx.normalized, ctx.disc = normalized, disc
        ctx.save_for_backward(x, maxval, mantissa_bits, sign_bits_f, hi_m,
                              m_round, m_lo, M, two_pow_E, two_pow_negM,
                              grid_top, minval, x_lo, xc, pow2,
                              factor, scales, m)
        return m * pow2 if normalized else m * scales

    @staticmethod
    def backward(ctx, ct):
        (x, maxval, mantissa_bits, sign_bits_f, hi_m, m_round, m_lo, M,
         two_pow_E, two_pow_negM, grid_top, minval, x_lo, xc, pow2,
         factor, scales, m) = ctx.saved_tensors
        # out = m * (pow2 or scales), m = disc(xc / scales)
        ct_u = ctx.disc.backward(ctx.disc_saved,
                                 ct * (pow2 if ctx.normalized else scales))
        ct_scales_div = -((ct_u * (1.0 / (scales * scales))) * xc)
        ct_xc = ct_u / scales
        if ctx.normalized:
            ct_factor = pow2 * ct_scales_div
            ct_pow2 = m * ct + ct_scales_div * factor
        else:
            ct_scales = m * ct + ct_scales_div
            ct_factor = pow2 * ct_scales
            ct_pow2 = ct_scales * factor
        # factor = maxval / grid_top
        ct_grid_top = -((ct_factor * (1.0 / (grid_top * grid_top))) * maxval)
        ct_maxval = ct_factor / grid_top
        # pow2 * exp2(g - g_det) with g = -M - 2^E + 1; exp2(0) == 1
        ct_g = _LN2 * (pow2 * ct_pow2)
        ct_M, ct_two_pow_E = -ct_g, -ct_g
        # xc = min(max(x, minval), maxval)
        ct_maxval = ct_maxval + ct_xc * _balanced(maxval, xc, x_lo)
        ct_x_lo = ct_xc * _balanced(x_lo, xc, maxval)
        ct_minval = ct_x_lo * _balanced(minval, x_lo, x)
        grad_x = ct_x_lo * _balanced(x, x_lo, minval)
        ct_maxval = ct_maxval + -torch.where(sign_bits_f > 0, ct_minval,
                                             torch.zeros_like(ct_minval))
        # grid_top = 2 - 2^-M, 2^E = 2^(hi - M)
        ct_M = ct_M + -(-ct_grid_top * (_LN2 * two_pow_negM))
        ct_M = ct_M + -(ct_two_pow_E * (_LN2 * two_pow_E))
        grad_mb = ((ct_M * _balanced(m_lo, M, hi_m))
                   * _balanced(m_round, m_lo, torch.ones_like(m_round)))
        return (grad_x.sum_to_size(x.shape),
                ct_maxval.sum_to_size(maxval.shape),
                grad_mb.sum_to_size(mantissa_bits.shape), None, None, None,
                None)


def quantize_to_fp8(x: torch.Tensor, maxval: torch.Tensor,
                    mantissa_bits: torch.Tensor, n_bits: int = 8,
                    sign_bits=1, normalized: bool = False,
                    discretizer: Discretizer = round_ste) -> torch.Tensor:
    """Fake-quantize ``x`` onto the FP8 grid of (maxval, mantissa_bits).

    ``maxval`` broadcasts against ``x`` (the caller owns the channel axis).
    ``mantissa_bits`` is a float tensor, rounded and clamped to
    ``[1, n_bits - sign_bits]`` on every call.  Rounding is
    ``discretizer``'s (``ops/rounding``): half to even with straight-through
    gradients by default.  ``normalized=True`` returns the value on the pure binary grid (an
    (M+1)-bit significand times a power of two, exact in bfloat16); the
    full-scale value is that times ``maxval / (2 - 2^-M)``.
    """
    dev = x.device
    maxval = torch.as_tensor(maxval, dtype=torch.float32, device=dev)
    mantissa_bits = torch.as_tensor(mantissa_bits, dtype=torch.float32, device=dev)
    sign_bits_f = torch.as_tensor(sign_bits, device=dev).to(torch.float32)
    return _QuantizeToFP8.apply(x, maxval, mantissa_bits, sign_bits_f, n_bits,
                                normalized, discretizer)


# Row order of the (6, C) constant tensor the kernels read; keep in step
# with struct Fp8Consts in csrc/fq_epilogue.cuh.
FP8_CONST_ROWS = ("minval", "maxval", "bias_int", "bias_frac_pow2", "g", "factor")


def fp8_consts(maxval: torch.Tensor, mantissa_bits, n_bits: int = 8,
               sign_bits=1) -> torch.Tensor:
    """The scalar algebra of a fixed FP8 quantizer as a ``(6, C)`` float32
    tensor (``C`` = 1 per tensor), rows as in ``FP8_CONST_ROWS``.

    Same formulas as ``quantize_to_fp8``, evaluated once; ``factor`` is the
    normalized-grid channel factor ``maxval / (2 - 2^-M)``.
    """
    maxval = torch.as_tensor(maxval, dtype=torch.float32).reshape(-1)
    dev = maxval.device
    mantissa_bits = torch.as_tensor(mantissa_bits, dtype=torch.float32, device=dev)
    sign_bits_f = torch.as_tensor(sign_bits, device=dev).to(torch.float32)
    M = _clip_mbits(mantissa_bits, n_bits, sign_bits_f, torch.round)
    E = float(n_bits) - sign_bits_f - M
    two_pow_E = 2.0 ** E
    grid_top = 2.0 - 2.0 ** (-M)
    bias = two_pow_E - torch.log2(maxval) + torch.log2(grid_top) - 1.0
    bias_int = torch.floor(bias)
    rows = [torch.where(sign_bits_f > 0, -maxval, torch.zeros_like(maxval)),
            maxval, bias_int, torch.exp2(bias - bias_int),
            -M - two_pow_E + 1.0, maxval / grid_top]
    return torch.stack([r.expand_as(maxval) for r in rows]).contiguous()


def fp8_quantize_prepared(x: torch.Tensor, c: torch.Tensor, *,
                          channel_axis: int = -1,
                          normalized: bool = False) -> torch.Tensor:
    """Fixed FP8 fake-quant of float32 ``x`` from ``fp8_consts`` output ``c``
    (per channel along ``channel_axis`` when ``c`` has C > 1 columns).

    The per-element pipeline of ``quantize_to_fp8`` (clip, exponent read,
    round half to even, rescale); the plain version of the kernels'
    ``fq_quantize`` device function.
    """
    if c.shape[1] > 1:
        shape = [1] * x.ndim
        shape[channel_axis] = c.shape[1]
        rows = (r.reshape(shape) for r in c)
    else:
        rows = c[:, 0]
    return fp8_quantize_rows(x, *rows, normalized=normalized)


def fp8_quantize_rows(x, lo, hi, bint, bfrac, g, factor, *,
                      normalized: bool = False) -> torch.Tensor:
    """``fp8_quantize_prepared`` with the six constant rows given apart,
    each broadcasting against ``x`` (the MSE search passes a chunk of
    candidates along a leading axis)."""
    xc = torch.minimum(torch.maximum(x, lo), hi)
    ls = torch.clamp(_floor_log2_exact(torch.abs(xc) * bfrac) + bint, min=1.0)
    pow2 = _exp2_int_exact(ls + g)
    m = torch.round(xc / (pow2 * factor))
    if normalized:
        return m * pow2
    return m * (pow2 * factor)


def fp8_set_quant_range(x_min, x_max, *, allow_unsigned: bool = False):
    """(maxval, sign_bits) from an estimated range: ``maxval =
    |max(|x_min|, x_max)|``; ``sign_bits`` is 0 iff ``allow_unsigned`` and
    the whole range is non-negative."""
    x_min = torch.as_tensor(x_min, dtype=torch.float32)
    x_max = torch.as_tensor(x_max, dtype=torch.float32, device=x_min.device)
    maxval = torch.abs(torch.maximum(torch.abs(x_min), x_max))
    if allow_unsigned:
        sign_bits = torch.where(torch.all(x_min >= 0), 0, 1).to(torch.int32)
    else:
        sign_bits = torch.ones((), dtype=torch.int32, device=x_min.device)
    return maxval, sign_bits


# IEEE-style 1-byte formats (inf and nan at the top exponent code) by
# mantissa bits: (f8_max, smallest_normal, storage dtype); JAX
# ``fp8_cast_dtype``'s float8_e5m2, float8_e4m3 and float8_e3m4
IEEE_F8 = {2: (57344.0, 2.0 ** -14, torch.float8_e5m2),
           3: (240.0, 2.0 ** -6, torch.float8_e4m3fn),
           4: (15.5, 2.0 ** -2, torch.bits8)}
# rows of the cast constants, after the six FP8_CONST_ROWS of a prepared
# quantizer that opts into the cast path (ops/quantizer.fixed_consts)
CAST_CONST_ROWS = ("cast_scale", "cast_lo", "cast_hi", "cast_sn",
                   "cast_magic", "cast_mbits")


def fp8_cast_consts(maxval: torch.Tensor, mantissa_bits, n_bits: int = 8,
                    sign_bits=1):
    """The cast path's constants as a ``(6, C)`` float32 tensor (rows
    ``CAST_CONST_ROWS``), or None where the path does not apply: n_bits
    other than 8, an unsigned grid, or M outside {2, 3, 4}.  Eligibility
    reads the values on the host (JAX checks concrete values too).

    ``cast_scale = maxval / f8_max`` equals the exact pipeline's factor
    over a power of two, so a division by it (never a reciprocal multiply,
    which flips about 2% of ties) rounds on the same mantissa; the IEEE
    grid covers every binade but the region below ``smallest_normal``,
    where the paper's grid is uniform with step ``h = sn * 2^-(M+1)`` and
    ``(y + 1.5*2^23*h) - 1.5*2^23*h`` rounds to it, ties to even."""
    if n_bits != 8 or int(torch.as_tensor(sign_bits)) != 1:
        return None
    mb = int(round(float(torch.as_tensor(mantissa_bits))))
    if mb not in IEEE_F8:
        return None
    f8_max, sn, _ = IEEE_F8[mb]
    maxval = torch.as_tensor(maxval, dtype=torch.float32).reshape(-1)
    h = sn * 2.0 ** -(mb + 1)
    rows = [torch.full_like(maxval, v) for v in (
        f8_max, -f8_max, f8_max, sn, 1.5 * 2.0 ** 23 * h, float(mb))]
    # a tensor divisor: CUDA divides by a Python number as a multiply by
    # its reciprocal, which is an ulp off the exact factor over 2^k
    rows[0] = maxval / rows[0]
    return torch.stack(rows).contiguous()


def cast_mbits(c: torch.Tensor) -> int:
    """The mantissa bits of cast constants ``c`` (a host read)."""
    return int(c[5, 0])


def _e3m4_round(y: torch.Tensor) -> torch.Tensor:
    """y (float32, within +-15.5) rounded to the IEEE E3M4 grid, ties to
    even: the step is 2^(e - 4) in binade e >= -2 and the subnormal step
    2^-6 below; every operation but the round is exact."""
    e = torch.clamp(_floor_log2_exact(torch.abs(y)), min=-2.0)
    step = _exp2_int_exact(e - 4.0)
    return torch.round(y / step) * step


def _e3m4_encode(q: torch.Tensor) -> torch.Tensor:
    """E3M4 grid values (float32) -> their IEEE codes as ``torch.bits8``
    (``torch.uint8`` while ``torch.export`` traces): sign, the exponent
    biased by 3, four mantissa bits; subnormals (below 2^-2) have exponent
    code 0 and mantissa q * 64."""
    sign = (q.view(torch.int32) >> 24) & 0x80
    a = torch.abs(q)
    bits = a.view(torch.int32)
    normal = (((bits >> 23) - 124) << 4) | ((bits >> 19) & 0xF)
    code = torch.where(a >= 0.25, normal, (a * 64.0).to(torch.int32)) | sign
    code = code.to(torch.uint8)
    return code if torch.compiler.is_exporting() else code.view(torch.bits8)


_E3M4_TABLES = {}


def _e3m4_table(device) -> torch.Tensor:
    """The 256 E3M4 code values as float32 on ``device`` (built once, but
    not kept when built while ``torch.export`` traces, where it would be a
    fake tensor)."""
    key = str(device)
    if key in _E3M4_TABLES:
        return _E3M4_TABLES[key]
    codes = np.arange(256)
    e, m = (codes >> 4) & 7, (codes & 15).astype(np.float64)
    v = np.where(e == 0, m * 2.0 ** -6, 2.0 ** (e - 3.0) * (1.0 + m / 16))
    v = np.where(e == 7, np.where(m == 0, np.inf, np.nan), v)
    v = np.where(codes & 0x80, -v, v)
    table = torch.tensor(v, dtype=torch.float32, device=device)
    if not torch.compiler.is_exporting():
        _E3M4_TABLES[key] = table
    return table


def ieee_decode(norm: torch.Tensor) -> torch.Tensor:
    """A 1-byte cast-path tensor as exact bfloat16 values (E3M4 codes,
    ``torch.bits8`` or ``torch.uint8``, through the code table, the torch f8
    dtypes by their own cast)."""
    if norm.dtype in (torch.bits8, torch.uint8):
        codes = norm.view(torch.uint8).to(torch.int64)
        return _e3m4_table(norm.device)[codes].to(torch.bfloat16)
    return norm.to(torch.bfloat16)


def ieee_store(y: torch.Tensor, mbits: int) -> torch.Tensor:
    """float32 y (within +-f8_max) as the 1-byte IEEE format with ``mbits``
    mantissa bits, rounded to nearest even: JAX ``y.astype(f8)``."""
    if mbits == 4:
        return _e3m4_encode(_e3m4_round(y))
    return y.to(IEEE_F8[mbits][2])


def ieee_round(y: torch.Tensor, mbits: int) -> torch.Tensor:
    """``ieee_store`` read back as float32 values."""
    if mbits == 4:
        return _e3m4_round(y)
    return y.to(IEEE_F8[mbits][2]).to(torch.float32)


def fp8_quantize_cast(x: torch.Tensor, c: torch.Tensor, *,
                      channel_axis: int = -1, normalized: bool = False,
                      store_f8: bool = False, ieee_subnorm: bool = False,
                      mbits=None):
    """Fixed FP8 fake-quant of float32 ``x`` by the saturating IEEE cast,
    from ``fp8_cast_consts`` output ``c`` (per channel along
    ``channel_axis`` when ``c`` has C > 1 columns); ``mbits``, when given,
    spares the host read of ``c``'s format.

    ``normalized`` returns ``fake_quant(x) / cast_scale`` in bfloat16 (an
    <= (M+1)-bit significand, exact) with ``factor = cast_scale``.
    ``store_f8`` (with ``normalized``) returns the 1-byte array itself
    (``ieee_store``): values below ``smallest_normal`` then land on the IEEE
    subnormal grid, whose step is twice the paper grid's bottom step.
    ``ieee_subnorm``: the same values as ``store_f8``, stored as the other
    modes store them."""
    mbits = cast_mbits(c) if mbits is None else mbits
    c = c.to(x.device)   # a CPU 0-dim divisor would be a reciprocal multiply
    if c.shape[1] > 1:
        shape = [1] * x.ndim
        shape[channel_axis] = c.shape[1]
        scale, lo, hi, sn, magic = (r.reshape(shape) for r in c[:5])
    else:
        scale, lo, hi, sn, magic = c[:5, 0]
    y = torch.clamp(x / scale, lo, hi)
    if store_f8:
        assert normalized, "store_f8 is a normalized-storage mode"
        return ieee_store(y, mbits)
    q = ieee_round(y, mbits)
    if not ieee_subnorm:
        q = torch.where(torch.abs(y) < sn, (y + magic) - magic, q)
    if normalized:
        return q.to(torch.bfloat16)
    return q * scale
