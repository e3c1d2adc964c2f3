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

The s8 input (no Pallas counterpart: JAX sends a ``PrequantS8`` input to
XLA's ``int8_matmul(x_prequant=True)``, nn/layers.py:1182-1216): ``x``
int8, already on the recentred input grid (nn/factored.PrequantS8), and
``a_scalars`` drive only the epilogue.  Two kernels take it, by a fixed
shape rule made before the launch (``sm90_takes``):

* at M >= 128 and K % 16 == 0 (TMA's 16-byte row stride), the Hopper
  kernel ``csrc/qmatmul_s8_sm90.cu`` (TMA, s8 wgmma, persistent tiles of
  128 x ``s8_tile`` columns), which also computes gelu and stores float32,
  bfloat16 (``out_bf16``) or s8 on the next consumer's grid (``emit_bits``
  with ``e_scalars`` = [delta, zero]: ops/int8.prequant_s8's rounding), so
  the ViT's gelu mlp1 with ``emit_s8`` runs on it (JAX: one
  ``int8_matmul(x_prequant=True, act_fn=gelu, emit_s8=...)``);
* any other s8 input with ``K % 4 == 0`` (``s8_input_ok``), e.g. the ViT's
  head at M = batch, the s8 branch of ``csrc/qmatmul_int8.cu``, staged as
  loaded, float32 out, no gelu and no emission; a CUDA x of another K raises.

``w`` is (N, K), torch's Linear layout.  The TPU tiling knobs and the K
padding of the Pallas wrapper do not carry over: ragged M, N and K are
masked in the kernels.

On the card the float32-x kernel is bound by bytes (float32 in and out, see
the note in csrc/qmatmul_int8.cu).  Each block owns a ``bm x bn`` output
tile and ``1 / splits`` of K (``int8_tile``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from fp8_quantization_tpu_torch.nn.activations import get_activation
from fp8_quantization_tpu_torch.ops.int8 import (
    act_int_params, int8_shifted_grid, prequant_s8, quantize_act)
from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.ops.kernels.common import (
    ACTIVATION_CODES, S8_ACTIVATION_CODES, SMS, on_card, require, stream_ptr)
from fp8_quantization_tpu_torch.utils.timing import span

REPLACES = "fp8_quantization_tpu/ops/pallas/qmatmul.py:212"
CHUNK_K = 32                # csrc/qmatmul_int8.cu: BK
MIN_BLOCKS = 128            # a launch with fewer splits K (one wave of 132 SMs)
MAX_SPLITS = 8              # ranks of a portable cluster
# (bm, bn) the kernel is built for; split K only with (64, 64)
TILES = ((64, 64), (64, 128), (64, 256), (32, 128), (32, 256))
# csrc/qmatmul_s8_sm90.cu: 128-row block tiles, 128-byte K chunks, these
# widths; its int32 total is exact for K up to S8_MAX_K
S8_BM, S8_BK, S8_WIDTHS, S8_MAX_K = 128, 128, (256, 192, 128), 16384


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


def sm90_takes(m: int, k: int) -> bool:
    """Whether an s8 input of ``m`` rows and row length ``k`` takes the
    Hopper kernel (csrc/qmatmul_s8_sm90.cu): a full 128-row tile, TMA's
    16-byte row stride and an exact int32 total.  Every other s8 input
    takes the s8 branch of csrc/qmatmul_int8.cu."""
    return m >= S8_BM and k % 16 == 0 and k <= S8_MAX_K


def s8_blocks(tiles: int, tiles_n: int) -> int:
    """The Hopper kernel's persistent grid (csrc/qmatmul_s8_sm90.cu:launch):
    one block a tile where they fit on the card's SMS, else one an SM, cut
    to a multiple of ``tiles_n`` so that each block keeps one column tile
    (its colsum and column constants set once)."""
    if tiles <= SMS:
        return tiles
    return SMS - SMS % tiles_n if tiles_n <= SMS else SMS


@functools.lru_cache(maxsize=None)
def s8_tile(m: int, n: int) -> int:
    """The Hopper kernel's tile width for an (M, K) x (N, K) product: of
    256, 192 and 128, the one whose waves of output tiles over its blocks
    (``s8_blocks``) cover the fewest columns, the narrower on a tie (its
    epilogue, which the products do not hide, is the shorter: ViT-S's mlp2
    takes 0.0319 ms at 128 against 0.0340 at 192, ops/kernels/variants.py
    on an H100 SXM at 700 W)."""
    tm = -(-m // S8_BM)

    def cost(bn):
        tn = -(-n // bn)
        return -(-tm * tn // s8_blocks(tm * tn, tn)) * bn

    return min(S8_WIDTHS, key=lambda bn: (cost(bn), bn))


def s8_schedule(m: int, n: int) -> list:
    """The output tiles ``(m0, n0)`` each persistent block of the Hopper
    kernel takes, in its order (block b takes tiles b, b + blocks, ...)."""
    bn = s8_tile(m, n)
    tiles_n = -(-n // bn)
    tiles = -(-m // S8_BM) * tiles_n
    blocks = s8_blocks(tiles, tiles_n)
    return [[((t // tiles_n) * S8_BM, (t % tiles_n) * bn)
             for t in range(b, tiles, blocks)] for b in range(blocks)]


@dataclasses.dataclass(frozen=True)
class Int8MatmulConfig:
    activation: Optional[str] = None    # None | "relu" | "relu6" | "gelu"
    n_bits: int = 8                     # weight grid bits
    act_n_bits: int = 8                 # input grid bits
    out_bf16: bool = False              # store bfloat16 (conv_out_bf16)
    emit_bits: Optional[int] = None     # s8 out on an emit_bits-bit grid

    def __post_init__(self):
        check_int8_config(self.activation, self.n_bits, self.act_n_bits)
        if self.emit_bits is not None and not 1 <= self.emit_bits <= 8:
            raise ValueError(f"emit_bits must be 1..8, got {self.emit_bits}")

    @property
    def sm90_only(self) -> bool:
        """gelu, bfloat16 or s8 out: only the Hopper s8 kernel has them."""
        return (self.activation not in ACTIVATION_CODES or self.out_bf16
                or self.emit_bits is not None)


def check_int8_config(activation, n_bits: int, act_n_bits: int) -> None:
    if activation not in S8_ACTIVATION_CODES:
        raise ValueError(f"int8 kernels take activation None, 'relu', "
                         f"'relu6' or (s8 input, Hopper kernel) 'gelu', "
                         f"not {activation!r}")
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
                       shift: torch.Tensor, cfg: Int8MatmulConfig,
                       e_scalars: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch, integer sums exact in
    float64 (CPU tests, card reference); an int8 ``x`` is the s8 operand
    itself.  The result after the activation is stored as the kernels
    store it: float32, bfloat16 (``out_bf16``) or, with ``e_scalars`` =
    [delta, zero], on that ``emit_bits`` grid as int8 (``prequant_s8``)."""
    dx, zp = act_int_params(a_scalars[0], a_scalars[1], cfg.act_n_bits)
    if x.dtype == torch.int8:
        xs = x.to(torch.float64)
    else:
        xs = quantize_act(x, dx, zp, cfg.act_n_bits).to(torch.float64)
    wsg = weight_grid(w, w_delta, w_scalars, cfg.n_bits)
    s_w = 128.0 * (1.0 - w_scalars[1])
    total = exact_total(xs @ wsg.t(), xs.sum(dim=1, keepdim=True),
                        wsg.sum(dim=1), x.shape[1], zp, s_w)
    y = epilogue(total, dx, w_delta, scale, shift, cfg.activation)
    check_emission(cfg, e_scalars)
    if e_scalars is not None:
        return prequant_s8(y, e_scalars[0], e_scalars[1], cfg.emit_bits)
    return y.to(torch.bfloat16) if cfg.out_bf16 else y


def check_emission(cfg: Int8MatmulConfig, e_scalars) -> None:
    """``e_scalars`` (2,) float32 goes with ``emit_bits``, and only so."""
    if (e_scalars is None) != (cfg.emit_bits is None):
        raise ValueError("qmatmul_int8: e_scalars and emit_bits go together")
    if e_scalars is not None:
        require(e_scalars, "e_scalars", (torch.float32,), (2,))


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
                            shift: torch.Tensor, *, cfg: Int8MatmulConfig,
                            e_scalars: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """y (M, N): float32, bfloat16 under ``cfg.out_bf16``, int8 with
    ``e_scalars`` (the emission grid's [delta, zero], ``cfg.emit_bits``).

    Args:
      x: (M, K) float32, quantized in the kernel, or int8 on the recentred
        input grid (``s8_input_ok(K)``; the Hopper kernel where
        ``sm90_takes(M, K)``).
      w: (N, K) int8 recentred grid (prequantized) or float32.
      w_delta: (N,) weight step; w_scalars: (2,) [0, signed];
      a_scalars: (3,) [dx, zero_float, 0]; scale, shift: (N,) float32.
    gelu, ``out_bf16`` and the emission need the Hopper kernel: on CUDA
    tensors another shape raises.  Calls the op ``fp8tpu::qmatmul_int8``
    (ops/kernels/library.py): CPU tensors take ``qmatmul_int8_plain``; CUDA
    tensors launch a kernel (``qmatmul_int8_cuda``).
    """
    M, K = x.shape
    N = w.shape[0]
    if tuple(w.shape) != (N, K):
        raise ValueError(f"w must be (N, K) = (*, {K}), got {tuple(w.shape)}")
    check_emission(cfg, e_scalars)
    with span("kernel.qmatmul_int8"):
        return torch.ops.fp8tpu.qmatmul_int8(
            x, w, w_delta, w_scalars, a_scalars, scale, shift, cfg.activation,
            cfg.n_bits, cfg.act_n_bits, e_scalars, cfg.emit_bits or 8,
            cfg.out_bf16)


def qmatmul_int8_cuda(x: torch.Tensor, w: torch.Tensor,
                      w_delta: torch.Tensor, w_scalars: torch.Tensor,
                      a_scalars: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, cfg: Int8MatmulConfig,
                      e_scalars: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The launch on CUDA tensors (op ``fp8tpu::qmatmul_int8``,
    ops/kernels/library.py): the Hopper kernel for an s8 input that
    ``sm90_takes``, else csrc/qmatmul_int8.cu; raises where neither can
    launch."""
    M, K = x.shape
    N = w.shape[0]
    args = (w_delta, w_scalars, a_scalars, scale, shift)
    on_card(x, w, *args, *(() if e_scalars is None else (e_scalars,)))
    require(x, "x", (torch.float32, torch.int8), vector_loads=True)
    require(w, "w", (torch.int8, torch.float32), vector_loads=True)
    check_scalars(N, *args)
    check_emission(cfg, e_scalars)
    x_int8 = x.dtype == torch.int8
    if x_int8 and w.dtype == torch.int8 and sm90_takes(M, K):
        return _launch_sm90(x, w, args, cfg, e_scalars)
    if cfg.sm90_only:
        raise ValueError(f"qmatmul_int8: gelu, bfloat16 and s8 outputs need "
                         f"the Hopper kernel (int8 x and w, M >= {S8_BM}, "
                         f"K % 16 == 0), got {x.dtype} x, {w.dtype} w, "
                         f"M = {M}, K = {K}")
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
    if x_int8:      # the s8 inputs' own count, within ``launches``
        fused_quant_matmul_int8.s8_launches += 1
    return out


def _launch_sm90(x, w, args, cfg, e_scalars):
    """csrc/qmatmul_s8_sm90.cu on an s8 x and a baked int8 w."""
    M, K = x.shape
    N = w.shape[0]
    w_delta, w_scalars, a_scalars, scale, shift = args
    out_dtype = (torch.int8 if e_scalars is not None
                 else torch.bfloat16 if cfg.out_bf16 else torch.float32)
    out = torch.empty((M, N), device=x.device, dtype=out_dtype)
    out_kind = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[out_dtype]
    err = build.entry("qmatmul_s8_sm90")(
        x.data_ptr(), w.data_ptr(), w_delta.data_ptr(), w_scalars.data_ptr(),
        a_scalars.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        None if e_scalars is None else e_scalars.data_ptr(), out.data_ptr(),
        M, N, K, cfg.act_n_bits, S8_ACTIVATION_CODES[cfg.activation],
        out_kind, cfg.emit_bits or 8, s8_tile(M, N), stream_ptr(x))
    build.check(err, "qmatmul_s8_sm90")
    fused_quant_matmul_int8.launches += 1
    fused_quant_matmul_int8.s8_launches += 1
    fused_quant_matmul_int8.sm90_launches += 1   # the Hopper kernel's own
    return out


fused_quant_matmul_int8.launches = 0
fused_quant_matmul_int8.s8_launches = 0
fused_quant_matmul_int8.sm90_launches = 0
