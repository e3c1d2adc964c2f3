"""Fused MobileNetV2 inverted-residual block:

    [expand 1x1 + fold + relu6 + quant] -> [depthwise 3x3 + fold + relu6 +
    quant] -> [project 1x1 + fold + quant] [+ residual + block quant]

Mirrors ``fused_inverted_residual`` of ``fp8_quantization_tpu/ops/pallas/
qblock.py`` (Pallas body ``_ir_block_kernel``, line 82; ``pallas_call`` at
line 267).  The Pallas kernel holds a group of whole images, expanded, in
VMEM; an SM's shared memory cannot.  The kernel, ``csrc/qblock.cu``, gives
a cluster of ``cs`` blocks one image's tile of output pixels, each block a
slice of the hidden channels walked in chunks (``block_tile`` chooses the
tile, the split and the chunk): it expands the tile's input pixels plus
their one-pixel halo for the chunk (bf16 tensor cores, fp32 sums), runs the
depthwise stencil on the chunk and adds the chunk's project product into
fp32 accumulators in registers; the cluster adds its blocks' partial sums
through distributed shared memory.  The expanded tensor never leaves the
SM.

Numerics are the Pallas body's, stage by stage (``qblock_plain``):

* the depthwise stage pads the *expanded* tensor with zeros (qblock.py:132):
  an input pixel outside the image is 0 after the expansion, not
  ``quant(relu6(shift1))``;
* each stage quantizes by its own method, "fp8" or "int_asym"; a stage
  whose method is "none" (the ``dw_bf16_acts`` preset) is a plain bf16
  cast, with no quant (qblock.py:69-80, 123-125, 141-143);
* with a residual the project output is quantized at full scale, then
  ``x * x_factor`` is added, then the block quantizer runs
  (qblock.py:152-162);
* the output is bf16 only when ``emit_norm`` holds and the final stage
  quantizes (qblock.py:232-235), float32 otherwise.

The quantizers arrive as one ``(6, 4)`` constant tensor (columns: expand,
dw, project, block), each column from ``ops/fp8.fp8_consts`` (maxval
floored at 1e-30 and mbits rounded and clipped there, the Pallas wrapper's
``_precondition_scalars``, which touches only the fp8 rows) or
``ops/uniform.int_asym_consts``.  The kernel's project sum runs over
chunks, so it is not bit-exact against the plain version's single fp32
matmul: it is held as the fused kernels are, >= 99% exactly equal and the
rest within one grid step.  The TPU knobs (``imgs_per_block``, the VMEM limit) do not carry
over.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.ops.kernels.common import (
    QUANT_CODES, SMEM_LIMIT, check_methods, on_card, quantize_prepared,
    require, stream_ptr)
from fp8_quantization_tpu_torch.ops.kernels.qdwconv import dw_taps_sum, out_hw
from fp8_quantization_tpu_torch.utils.timing import span

REPLACES = "fp8_quantization_tpu/ops/pallas/qblock.py:82"
ROW_EXPAND, ROW_DW, ROW_PROJECT, ROW_BLOCK = 0, 1, 2, 3

# csrc/qblock.cu's launches: (warps a block, (16 x 8) project tiles a warp
# keeps in registers at most) -> the shared memory that lets its blocks a
# SM fit (three, two, one): partial-image tiles take 8 warps, whole images 16
LAUNCHES = {(8, 4): 75 * 1024, (8, 8): 113 * 1024, (16, 10): 232448}
MAX_TILE_ROWS = 256             # output pixels of a partial-image tile
CHUNKS = (64, 48, 32, 16)       # hidden channels per chunk


def _align128(v: int) -> int:
    return -(-v // 128) * 128


def _round16(v: int) -> int:
    return -(-v // 16) * 16


@dataclasses.dataclass(frozen=True)
class BlockTile:
    """One launch's tiling: ``th x tw`` output pixels of one image a
    cluster of ``cs`` blocks, each block ``hid / cs`` hidden channels (in
    units of 16) in chunks of ``hc``, ``warps`` warps a block, each at most
    ``maxt`` project tiles in registers."""
    th: int
    tw: int
    cs: int
    hc: int
    warps: int
    maxt: int

    def halo(self, stride: int) -> Tuple[int, int]:
        """Input pixels (rows, columns) a tile expands: its outputs' 3x3
        windows."""
        return (self.th - 1) * stride + 3, (self.tw - 1) * stride + 3

    def tiles(self, ho: int, wo: int) -> int:
        return -(-ho // self.th) * -(-wo // self.tw)

    def slices(self, hid: int):
        """[lo, hi) hidden channels of each rank of the cluster."""
        units = -(-hid // 16)
        return [(16 * (r * units // self.cs),
                 min(16 * ((r + 1) * units // self.cs), hid))
                for r in range(self.cs)]

    def smem_bytes(self, stride: int, cin: int, cout: int,
                   expand: bool) -> int:
        """Shared memory of one block, as csrc/qblock.cu's make_geometry
        lays it out: the input tile, a two-stage ring of the chunk's
        weights (w1, w2, 9 tap rows and 4 folded vectors), the expanded
        chunk and the dw output; the fp32 partial sums alias the ring."""
        ph, pw = self.halo(stride)
        pp, kp, rp = _round16(ph * pw), _round16(cin), _round16(self.th * self.tw)
        ring = _align128(pp * (kp + 8) * 2)
        w2 = kp * (self.hc + 8) * 2 if expand else 0
        stage = _align128(w2 + self.hc * (cout + 8) * 2 + 13 * self.hc * 4)
        hs = _align128(pp * (self.hc + 8) * 2) if expand else 0
        end = ring + 2 * stage + hs + _align128(rp * (self.hc + 8) * 2)
        return max(end, ring + rp * (cout + 4) * 4)

    def warp_tiles(self, cout: int) -> int:
        """Project tiles (16 pixels x 8 channels) of the busiest warp."""
        return -(-(_round16(self.th * self.tw) // 16) * (cout // 8) // self.warps)


@functools.lru_cache(maxsize=None)
def block_tile(h: int, w: int, stride: int, cin: int, hid: int, cout: int,
               expand: bool) -> BlockTile:
    """The kernel's tiling of one block shape.

    Maps of at most 16 x 16 output pixels whose accumulators fit sixteen
    warps (every MobileNetV2 map from 14x14 down) take whole images, and
    split hid over a cluster of 2 blocks: each stages half the weights
    once per image, the expansion is recomputed on no inner halo, and
    batch 64 launches 128 blocks of one SM each, a single wave (splitting
    4 ways gives 256 blocks in two waves, and each block pays its fixed
    cost twice as often: 1.6x slower on the card, PERF.md).  Larger maps
    take the tile of at most 256 pixels that computes the fewest expanded
    pixels (its halo and the ragged edge included), the fewer tiles on a
    tie, then the wider, on eight warps with 4 project tiles each where
    they fit (three blocks an SM), else 8 (two); where no chunk lets two
    blocks share an SM, one block of sixteen warps takes the tile.  The
    chunk is the one of ``CHUNKS`` that fits the launch's blocks an SM
    with the fewest chunks a slice, then the least padding, then the
    widest."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    units = -(-hid // 16)

    def tile(th, tw, warps, maxt, cs=1, hc=16):
        return BlockTile(th, tw, cs, hc, warps, maxt)

    def fits(th, tw, warps, maxt):
        return tile(th, tw, warps, maxt).warp_tiles(cout) <= maxt

    if ho * wo <= 256 and ho <= 16 and wo <= 16 and fits(ho, wo, 16, 10):
        th, tw, cs, warps, maxt = ho, wo, min(2, units), 16, 10
    else:
        best = None
        for th in range(1, min(ho, MAX_TILE_ROWS) + 1):
            for tw in range(1, min(wo, MAX_TILE_ROWS // th) + 1):
                cand = tile(th, tw, 8, 8)
                if (not fits(th, tw, 8, 8)
                        or cand.smem_bytes(stride, cin, cout, expand) > SMEM_LIMIT):
                    continue
                ph, pw = cand.halo(stride)
                key = (cand.tiles(ho, wo) * ph * pw, cand.tiles(ho, wo), th)
                if best is None or key < best[0]:
                    best = (key, th, tw)
        _, th, tw = best
        cs, warps, maxt = 1, 8, (4 if fits(th, tw, 8, 4) else 8)
    slice_ch = 16 * -(-units // cs)

    def fitting(warps, maxt, limit):
        return [hc for hc in CHUNKS if tile(th, tw, warps, maxt, cs, hc).smem_bytes(
            stride, cin, cout, expand) <= limit]
    chunks = fitting(warps, maxt, LAUNCHES[warps, maxt])
    if not chunks and warps == 8:       # one block an SM: make it sixteen warps
        warps, maxt = 16, 10
        chunks = fitting(warps, maxt, SMEM_LIMIT)
    if not chunks:
        raise ValueError(f"qblock: no tiling of {h}x{w} {cin}->{hid}->{cout} "
                         f"s{stride} fits the card's shared memory")
    hc = min(chunks, key=lambda c: (-(-slice_ch // c), -(-slice_ch // c) * c, -c))
    return BlockTile(th, tw, cs, hc, warps, maxt)


@dataclasses.dataclass(frozen=True)
class FusedBlockConfig:
    expand: bool = True                 # False for a t=1 block
    stride: int = 1                     # the depthwise stride, 1 or 2
    use_res: bool = False               # residual add + block quant
    emit_norm: bool = False             # final output as normalized bf16
    # output quant per stage (expand, dw, project, block): "fp8" |
    # "int_asym" | "none"
    methods: Tuple[str, str, str, str] = ("fp8", "fp8", "fp8", "fp8")

    def __post_init__(self):
        for m in self.methods:
            check_methods(m, None)
        if self.stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {self.stride}")
        if self.use_res and self.stride != 1:
            raise ValueError("a residual block has stride 1")

    @property
    def final_row(self) -> int:
        return ROW_BLOCK if self.use_res else ROW_PROJECT

    @property
    def out_bf16(self) -> bool:
        return self.emit_norm and self.methods[self.final_row] != "none"


def _stage_quant(y, a_consts, cfg: FusedBlockConfig, row: int,
                 normalized: bool):
    return quantize_prepared(y, cfg.methods[row], a_consts[:, row:row + 1],
                             normalized=normalized)


def _relu6(y):
    return torch.clamp(y, 0.0, 6.0)


def qblock_plain(x, w1, wd, w2, a_consts, scale1, shift1, scale_d, shift_d,
                 scale2, shift2, x_factor, cfg: FusedBlockConfig):
    """The kernel's arithmetic in plain PyTorch (CPU tests, card reference),
    with the project product as one fp32 matmul.  On the card call it under
    ``common.no_tf32()``."""
    n, h, w, cin = x.shape
    hid, cout = w2.shape
    xb = x.to(torch.bfloat16).to(torch.float32)
    hcur = xb
    if cfg.expand:
        y1 = xb.reshape(-1, cin) @ w1.to(torch.float32)
        y1 = _relu6(y1 * scale1 + shift1)
        hcur = (_stage_quant(y1, a_consts, cfg, ROW_EXPAND, True)
                .to(torch.bfloat16).to(torch.float32).reshape(n, h, w, hid))
    yd = dw_taps_sum(hcur, wd.to(torch.float32), cfg.stride)
    yd = _relu6(yd * scale_d + shift_d)
    n2 = _stage_quant(yd, a_consts, cfg, ROW_DW, True).to(torch.bfloat16)
    ho, wo = out_hw(h, w, cfg.stride)
    y2 = (n2.to(torch.float32).reshape(-1, hid) @ w2.to(torch.float32))
    y2 = y2.reshape(n, ho, wo, cout) * scale2 + shift2
    if cfg.use_res:
        y2 = _stage_quant(y2, a_consts, cfg, ROW_PROJECT, False)
        y2 = y2 + xb * x_factor
    y = _stage_quant(y2, a_consts, cfg, cfg.final_row, cfg.emit_norm)
    return y.to(torch.bfloat16 if cfg.out_bf16 else torch.float32).contiguous()


def _vec(t: torch.Tensor, n: int, name: str) -> None:
    require(t, name, (torch.float32,), (n,))


def fused_inverted_residual(x: torch.Tensor, w1: Optional[torch.Tensor],
                            wd: torch.Tensor, w2: torch.Tensor,
                            a_consts: torch.Tensor,
                            scale1: Optional[torch.Tensor],
                            shift1: Optional[torch.Tensor],
                            scale_d: torch.Tensor, shift_d: torch.Tensor,
                            scale2: torch.Tensor, shift2: torch.Tensor,
                            x_factor: Optional[torch.Tensor] = None, *,
                            cfg: FusedBlockConfig) -> torch.Tensor:
    """One inverted-residual block, fused.

    Args:
      x: (N, H, W, Cin) bf16 input norms (or bf16 values).
      w1: (Cin, hid) bf16 baked expand weights, or None (t=1 blocks).
      wd: (3, 3, hid) float32 baked depthwise taps (bf16-exact).
      w2: (hid, Cout) bf16 baked project weights.
      a_consts: (6, 4) float32 quantizer constants, one column per stage
        (expand, dw, project, block); a "none" stage's column is unused.
      scale*/shift*: (hid,) or (Cout,) float32 folded epilogues, each stage's
        scale carrying its upstream stage's factor.
      x_factor: () float32, the input's factor (residual blocks).
    Calls the op ``fp8tpu::qblock`` (ops/kernels/library.py): CPU tensors
    take ``qblock_plain``; CUDA tensors launch the kernel (``qblock_cuda``).
    """
    n, h, w, cin = x.shape
    hid = wd.shape[-1]
    cout = w2.shape[-1]
    if cfg.expand != (w1 is not None) or cfg.expand != (scale1 is not None):
        raise ValueError("w1, scale1 and shift1 are given iff cfg.expand")
    if cfg.expand and w1.shape != (cin, hid):
        raise ValueError(f"w1 must be ({cin}, {hid}), got {tuple(w1.shape)}")
    if not cfg.expand and hid != cin:
        raise ValueError("a block without expansion has hid == Cin")
    if w2.shape != (hid, cout) or wd.shape != (3, 3, hid):
        raise ValueError(f"wd must be (3, 3, hid) and w2 (hid, Cout), got "
                         f"{tuple(wd.shape)} and {tuple(w2.shape)}")
    if cfg.use_res and (cout != cin or x_factor is None):
        raise ValueError("a residual block needs Cout == Cin and x_factor")
    if cfg.stride == 2 and (h % 2 or w % 2):
        raise ValueError(f"stride 2 needs even H and W, got {h}x{w}")
    if x_factor is None:
        x_factor = torch.ones((), device=x.device)
    x_factor = x_factor.reshape(()).to(torch.float32)
    with span("kernel.qblock"):
        return torch.ops.fp8tpu.qblock(
            x, w1, wd, w2, a_consts, scale1, shift1, scale_d, shift_d,
            scale2, shift2, x_factor, cfg.expand, cfg.stride, cfg.use_res,
            cfg.emit_norm, ",".join(cfg.methods))


def channels_ok(cin: int, hid: int, cout: int) -> bool:
    """Whether the kernel takes a block of these widths: it copies rows of
    16 bytes, so each is a multiple of 8 (MobileNetV2 at width_mult 1.4
    has blocks of 22, 33, 89 ... channels, which go layer by layer)."""
    return cin % 8 == 0 and hid % 8 == 0 and cout % 8 == 0


def qblock_cuda(x, w1, wd, w2, a_consts, scale1, shift1, scale_d, shift_d,
                scale2, shift2, x_factor, cfg: FusedBlockConfig):
    """The kernel's launch on CUDA tensors (op ``fp8tpu::qblock``,
    ops/kernels/library.py); raises where it cannot launch."""
    n, h, w, cin = x.shape
    hid = wd.shape[-1]
    cout = w2.shape[-1]
    opt = [t for t in (w1, scale1, shift1) if t is not None]
    on_card(x, wd, w2, a_consts, scale_d, shift_d, scale2, shift2, x_factor,
            *opt)
    require(x, "x", (torch.bfloat16,))
    require(wd, "wd", (torch.float32,))
    require(w2, "w2", (torch.bfloat16,))
    require(a_consts, "a_consts", (torch.float32,), (6, 4))
    for t, nm, c in ((scale_d, "scale_d", hid), (shift_d, "shift_d", hid),
                     (scale2, "scale2", cout), (shift2, "shift2", cout)):
        _vec(t, c, nm)
    if cfg.expand:
        require(w1, "w1", (torch.bfloat16,))
        _vec(scale1, hid, "scale1")
        _vec(shift1, hid, "shift1")
    x_factor = x_factor.contiguous()
    if not channels_ok(cin, hid, cout):
        raise ValueError(f"qblock on the card copies 16-byte rows: Cin, hid "
                         f"and Cout must be multiples of 8, got {cin}, {hid}, "
                         f"{cout}")
    for t, nm in ((x, "x"), (w1, "w1"), (wd, "wd"), (w2, "w2"),
                  (scale1, "scale1"), (shift1, "shift1"), (scale_d, "scale_d"),
                  (shift_d, "shift_d"), (scale2, "scale2"), (shift2, "shift2")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"qblock on the card: {nm} must be 16-byte aligned")
    tile = block_tile(h, w, cfg.stride, cin, hid, cout, cfg.expand)
    ho, wo = out_hw(h, w, cfg.stride)
    out = torch.empty((n, ho, wo, cout), device=x.device,
                      dtype=torch.bfloat16 if cfg.out_bf16 else torch.float32)
    # two bits per stage, stage r at bit 2r (csrc/qblock.cu)
    methods = sum(QUANT_CODES[m] << (2 * r) for r, m in enumerate(cfg.methods))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = build.entry("qblock")(
        x.data_ptr(), ptr(w1), wd.data_ptr(), w2.data_ptr(),
        a_consts.data_ptr(), ptr(scale1), ptr(shift1), scale_d.data_ptr(),
        shift_d.data_ptr(), scale2.data_ptr(), shift2.data_ptr(),
        x_factor.data_ptr(), out.data_ptr(), n, h, w, cin, hid, cout,
        cfg.stride, int(cfg.expand), int(cfg.use_res), methods,
        int(cfg.emit_norm), int(cfg.out_bf16), tile.th, tile.tw, tile.cs,
        tile.hc, tile.warps, tile.maxt, stream_ptr(x))
    build.check(err, "qblock")
    fused_inverted_residual.launches += 1
    return out


fused_inverted_residual.launches = 0
