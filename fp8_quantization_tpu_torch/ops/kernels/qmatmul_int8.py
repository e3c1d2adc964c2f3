"""Int8 quant-matmul: ``y = epilogue(xs @ wsg^T + corrections)``.

Mirrors the int8 path of ``fused_quant_matmul`` in ``fp8_quantization_tpu/
ops/pallas/qmatmul.py`` (``mxu_dtype="int8"``: Pallas body
``_qmatmul_int8_kernel``, line 212; ``pallas_call`` at line 389).  The
kernel is ``csrc/qmatmul_int8.cu`` with ``csrc/int8_epilogue.cuh``.

It computes, for x quantized on the asymmetric input grid and w on the
symmetric weight grid (both recentred to s8, see ops/int8.py)::

    y = act(((dot(xs, wsg) + S_w*rowsum(xs) + (128-zp)*colsum(wsg)
              + K*(128-zp)*S_w) * (dx * max(dw, 1e-8))) * scale + shift)

with the integer total exact and converted to float once.  The Pallas
kernel adds the corrections in f32, which gives the same result while the
sums stay below 2^24.  Semantics carried over: in-kernel weight quant
(``w`` float32) or ``w_prequant`` (``w`` int8, from
nn/bake.bake_int8_weights), signed and unsigned weight grids, relu/relu6.

The s8 input branch (no Pallas counterpart: JAX sends a ``PrequantS8``
input to XLA's ``int8_matmul(x_prequant=True)``, nn/layers.py:1182-1216):
``x`` int8, already on the recentred input grid (nn/factored.PrequantS8),
is staged as it is, and ``a_scalars`` drive only the epilogue.  It needs
``K % 4 == 0`` (``s8_input_ok``); a CUDA x of another K raises.
``w`` is (N, K), torch's Linear layout.  The TPU tiling knobs and the K
padding of the Pallas wrapper do not carry over: ragged M, N and K are
masked in the kernel.

On the card the kernel is bound by bytes (float32 in and out, see the note
in csrc/qmatmul_int8.cu).  Each block owns a ``bm x bn`` output tile and
``1 / splits`` of K (``int8_tile``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from fp8_quantization_tpu_torch.nn.activations import get_activation
from fp8_quantization_tpu_torch.ops.int8 import (
    act_int_params, int8_shifted_grid, quantize_act)
from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.ops.kernels.common import (
    ACTIVATION_CODES, on_card, require, stream_ptr)

REPLACES = "fp8_quantization_tpu/ops/pallas/qmatmul.py:212"
CHUNK_K = 32                # csrc/qmatmul_int8.cu: BK
MIN_BLOCKS = 128            # a launch with fewer splits K (one wave of 132 SMs)
MAX_SPLITS = 8              # ranks of a portable cluster
# (bm, bn) the kernel is built for; split K only with (64, 64)
TILES = ((64, 64), (64, 128), (64, 256), (32, 128), (32, 256))


@dataclasses.dataclass(frozen=True)
class Int8Tile:
    """A block's share: ``bm x bn`` outputs and the K chunks
    ``[z * nch // splits, (z + 1) * nch // splits)`` of its rank z."""
    bm: int
    bn: int
    splits: int = 1

    def blocks(self, m: int, n: int) -> int:
        return -(-m // self.bm) * -(-n // self.bn) * self.splits

    def chunks(self, k: int, z: int) -> range:
        nch = -(-k // CHUNK_K)
        return range(z * nch // self.splits, (z + 1) * nch // self.splits)


@functools.lru_cache(maxsize=None)
def int8_tile(m: int, n: int, k: int) -> Int8Tile:
    """The kernel's tile for an (M, K) x (N, K) product: bn the least of
    64, 128, 256 that covers N (256 above), so that x is read and quantized
    once per column tile (N <= 256) or twice (N = 512); bm 64, or 32 where
    64 leaves fewer than MIN_BLOCKS blocks; where even that does (the fc,
    M = batch), a 64 x 64 tile with K split over up to 8 cluster ranks (at
    most one a chunk of 32), the fewest that reach MIN_BLOCKS."""
    bn = next((w for w in (64, 128, 256) if n <= w), 256)
    tile = Int8Tile(64, bn)
    if tile.blocks(m, n) < MIN_BLOCKS and bn >= 128:
        tile = Int8Tile(32, bn)
    if tile.blocks(m, n) >= MIN_BLOCKS:
        return tile
    nch = -(-k // CHUNK_K)
    splits = 1
    while (Int8Tile(64, 64, splits).blocks(m, n) < MIN_BLOCKS
           and 2 * splits <= min(MAX_SPLITS, nch)):
        splits *= 2
    return Int8Tile(64, 64, splits) if splits > 1 else tile


@dataclasses.dataclass(frozen=True)
class Int8MatmulConfig:
    activation: Optional[str] = None    # None | "relu" | "relu6"
    n_bits: int = 8                     # weight grid bits
    act_n_bits: int = 8                 # input grid bits

    def __post_init__(self):
        check_int8_config(self.activation, self.n_bits, self.act_n_bits)


def check_int8_config(activation, n_bits: int, act_n_bits: int) -> None:
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"int8 kernels take activation None, 'relu' or "
                         f"'relu6', not {activation!r}")
    if not (2 <= n_bits <= 8 and 1 <= act_n_bits <= 8):
        raise ValueError(f"int8 kernels need <= 8-bit grids, got weights "
                         f"{n_bits}, inputs {act_n_bits}")


def exact_total(acc, xs_rowsum, wsg_colsum, k: int, zp, s_w):
    """The recentred identity's integer total in float64 (exact)."""
    c = (128.0 - zp).to(torch.float64)
    s_w = s_w.to(torch.float64)
    return acc + s_w * xs_rowsum + c * wsg_colsum + float(k) * c * s_w


def epilogue(total, dx, w_delta, scale, shift, activation):
    """The float epilogue of both int8 kernels, in their order."""
    y = total.to(torch.float32) * (dx * torch.clamp(w_delta, min=1e-8))
    y = y * scale + shift
    act = get_activation(activation)
    return act(y) if act is not None else y


def weight_grid(w, w_delta, w_scalars, n_bits: int) -> torch.Tensor:
    """The (C, K) recentred weight grid as float64: ``w`` itself when it is
    the baked int8 grid, else quantized per row."""
    if w.dtype == torch.int8:
        return w.to(torch.float64)
    return int8_shifted_grid(w.to(torch.float32), w_delta[:, None],
                             w_scalars[1], n_bits).to(torch.float64)


def qmatmul_int8_plain(x: torch.Tensor, w: torch.Tensor,
                       w_delta: torch.Tensor, w_scalars: torch.Tensor,
                       a_scalars: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor,
                       cfg: Int8MatmulConfig) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, integer sums exact in
    float64 (CPU tests, card reference); an int8 ``x`` is the s8 operand
    itself."""
    dx, zp = act_int_params(a_scalars[0], a_scalars[1], cfg.act_n_bits)
    if x.dtype == torch.int8:
        xs = x.to(torch.float64)
    else:
        xs = quantize_act(x, dx, zp, cfg.act_n_bits).to(torch.float64)
    wsg = weight_grid(w, w_delta, w_scalars, cfg.n_bits)
    s_w = 128.0 * (1.0 - w_scalars[1])
    total = exact_total(xs @ wsg.t(), xs.sum(dim=1, keepdim=True),
                        wsg.sum(dim=1), x.shape[1], zp, s_w)
    return epilogue(total, dx, w_delta, scale, shift, cfg.activation)


def s8_input_ok(k: int) -> bool:
    """Whether the kernel takes an int8 x of row length ``k``: each row's
    values load four to a word."""
    return k % 4 == 0


def check_scalars(n: int, w_delta, w_scalars, a_scalars, scale, shift):
    require(w_delta, "w_delta", (torch.float32,), (n,))
    require(w_scalars, "w_scalars", (torch.float32,), (2,))
    require(a_scalars, "a_scalars", (torch.float32,), (3,))
    require(scale, "scale", (torch.float32,), (n,))
    require(shift, "shift", (torch.float32,), (n,))


def fused_quant_matmul_int8(x: torch.Tensor, w: torch.Tensor,
                            w_delta: torch.Tensor, w_scalars: torch.Tensor,
                            a_scalars: torch.Tensor, scale: torch.Tensor,
                            shift: torch.Tensor, *,
                            cfg: Int8MatmulConfig) -> torch.Tensor:
    """y (M, N) float32.

    Args:
      x: (M, K) float32, quantized in the kernel, or int8 on the recentred
        input grid (the s8 input branch; ``s8_input_ok(K)``).
      w: (N, K) int8 recentred grid (prequantized) or float32.
      w_delta: (N,) weight step; w_scalars: (2,) [0, signed];
      a_scalars: (3,) [dx, zero_float, 0]; scale, shift: (N,) float32.
    Calls the op ``fp8tpu::qmatmul_int8`` (ops/kernels/library.py): CPU
    tensors take ``qmatmul_int8_plain``; CUDA tensors launch the kernel
    (``qmatmul_int8_cuda``).
    """
    M, K = x.shape
    N = w.shape[0]
    if tuple(w.shape) != (N, K):
        raise ValueError(f"w must be (N, K) = (*, {K}), got {tuple(w.shape)}")
    return torch.ops.fp8tpu.qmatmul_int8(
        x, w, w_delta, w_scalars, a_scalars, scale, shift, cfg.activation,
        cfg.n_bits, cfg.act_n_bits)


def qmatmul_int8_cuda(x: torch.Tensor, w: torch.Tensor,
                      w_delta: torch.Tensor, w_scalars: torch.Tensor,
                      a_scalars: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor,
                      cfg: Int8MatmulConfig) -> torch.Tensor:
    """The kernel's launch on CUDA tensors (op ``fp8tpu::qmatmul_int8``,
    ops/kernels/library.py); raises where it cannot launch."""
    M, K = x.shape
    N = w.shape[0]
    args = (w_delta, w_scalars, a_scalars, scale, shift)
    on_card(x, w, *args)
    require(x, "x", (torch.float32, torch.int8), vector_loads=True)
    require(w, "w", (torch.int8, torch.float32), vector_loads=True)
    check_scalars(N, *args)
    x_int8 = x.dtype == torch.int8
    if x_int8 and not s8_input_ok(K):
        raise ValueError(f"qmatmul_int8: an int8 x needs K % 4 == 0, got K = {K}")
    out = torch.empty((M, N), device=x.device, dtype=torch.float32)
    tile = int8_tile(M, N, K)
    err = build.entry("qmatmul_int8")(
        x.data_ptr(), w.data_ptr(), int(w.dtype == torch.int8), int(x_int8),
        w_delta.data_ptr(), w_scalars.data_ptr(), a_scalars.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), out.data_ptr(), M, N, K,
        cfg.act_n_bits, cfg.n_bits, ACTIVATION_CODES[cfg.activation],
        tile.bm, tile.bn, tile.splits, stream_ptr(x))
    build.check(err, "qmatmul_int8")
    fused_quant_matmul_int8.launches += 1
    if x_int8:      # the s8 input branch's own count, within ``launches``
        fused_quant_matmul_int8.s8_launches += 1
    return out


fused_quant_matmul_int8.launches = 0
fused_quant_matmul_int8.s8_launches = 0
