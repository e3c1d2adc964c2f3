"""Host-side tiling of the redesigned CUDA kernels (CPU; no JAX needed).

The fused inverted-residual block (csrc/qblock.cu) gives a cluster of
``cs`` blocks one image's ``th x tw`` output tile and each block a slice
of the hidden channels (``block_tile``); flash attention (csrc/
flash_mha.cu) gives each block a group of query rows (``flash_grid``).

The quant-matmul (csrc/qmatmul.cu) launches ``ceil(M / 128) x ceil(N / BN)``
blocks with ``BN = tile_n(N)``; the int8 3x3 conv (csrc/qconv_int8.cu)
gives each block a ``th x tw`` tile of one image's output pixels and
``bn`` output channels (``conv_tile``); the 3x3 conv (csrc/qconv.cu) 128
output pixels by ``bn`` channels (``qconv.conv_tile``), gathering K =
9*Cin in chunks of 64; the int8 quant-matmul (csrc/qmatmul_int8.cu) a
``bm x bn`` tile and a share of K (``int8_tile``).  These tests hold the choices to
what the kernels assume at every shape of ResNet-18, MobileNetV2 and
ViT-S/16 at batch 64 and at the edges the kernels mask: each output is
covered exactly once, a tile fits its block's shared memory, and small N
keeps a full tile.  The kernels themselves run only on the card
(chip_smoke.py); their plain versions are tested elsewhere.  Last, the
source variants that ops/kernels/variants.py times on the card still
apply to the current sources.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from fp8_quantization_tpu_torch.ops.kernels import attention as at
from fp8_quantization_tpu_torch.ops.kernels import qblock as qb
from fp8_quantization_tpu_torch.ops.kernels import qconv as q3
from fp8_quantization_tpu_torch.ops.kernels import qconv_int8 as qc
from fp8_quantization_tpu_torch.ops.kernels import qdwconv as qd
from fp8_quantization_tpu_torch.ops.kernels import qmatmul as qm
from fp8_quantization_tpu_torch.ops.kernels import qmatmul_int8 as q8
from fp8_quantization_tpu_torch.ops.kernels import qstem as qs
from fp8_quantization_tpu_torch.ops.kernels import variants
from fp8_quantization_tpu_torch.ops.kernels.common import SMEM_LIMIT, SMS

B = 64


def _mnv2_matmuls():
    """(M, K, N) of MobileNetV2's 1x1 convs and classifier under folded BN
    (tonylins topology, 224x224 input)."""
    shapes, cin, hw = [], 32, 112
    for t, c, n, s in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                       (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)):
        for i in range(n):
            hidden = cin * t
            if t != 1:
                shapes.append((B * hw * hw, cin, hidden))           # expand
            hw = hw // 2 if (i == 0 and s == 2) else hw
            shapes.append((B * hw * hw, hidden, c))                 # project
            cin = c
    shapes += [(B * 7 * 7, 320, 1280), (B, 1280, 1000)]
    return shapes


RESNET_MATMULS = [(B * 28 * 28, 64, 128), (B * 14 * 14, 128, 256),
                  (B * 7 * 7, 256, 512), (B, 512, 1000)]
VIT_MATMULS = [(B * 197, 384, 1152), (B * 197, 384, 384), (B * 197, 1536, 384),
               (B, 384, 1000)]
EDGE_MATMULS = [(12608, 1000, 24), (64, 72, 16), (1000, 72, 24), (300, 1000, 144),
                (777, 40, 1000), (1, 8, 1), (129, 8, 17)]
MATMULS = sorted(set(RESNET_MATMULS + VIT_MATMULS + _mnv2_matmuls() + EDGE_MATMULS))


@pytest.mark.parametrize("m,k,n", MATMULS)
def test_qmatmul_tiles_cover_every_output_once(m, k, n):
    """The kernel's launch grid, ceil(M / 128) x ceil(N / tile_n(N)),
    covers each of the M x N outputs exactly once, with a width the kernel
    is built for."""
    bn = qm.tile_n(n)
    rows, cols = -(-m // qm.TILE_M), -(-n // bn)
    assert bn in qm.TILE_NS
    count = np.zeros((m, n), np.int32) if m * n <= 4_000_000 else None
    covered = 0
    for i in range(rows):
        for j in range(cols):
            r0, c0 = i * qm.TILE_M, j * bn
            r1, c1 = min(m, r0 + qm.TILE_M), min(n, c0 + bn)
            assert r0 < r1 and c0 < c1          # no block without outputs
            covered += (r1 - r0) * (c1 - c0)
            if count is not None:
                count[r0:r1, c0:c1] += 1
    assert covered == m * n
    if count is not None:
        assert (count == 1).all()


@pytest.mark.parametrize("n,want", [(1, 16), (8, 16), (16, 16), (24, 32), (32, 32),
                                    (48, 64), (64, 64), (96, 64), (144, 64),
                                    (160, 64), (384, 64), (1000, 64), (1152, 64)])
def test_qmatmul_small_n_keeps_a_full_tile(n, want):
    """MobileNetV2's 16-, 24- and 32-channel 1x1s keep a tile no wider
    than they need; a wide N takes the widest tile, 64."""
    assert qm.tile_n(n) == want
    waste = math.ceil(n / want) * want / n
    assert n < 16 or waste <= 4 / 3


@pytest.mark.parametrize("k,offset,copyable", [(64, 0, True), (72, 0, True),
                                               (1000, 0, True), (27, 0, False),
                                               (64, 4, False)])
def test_qmatmul_copies_only_aligned_bf16_rows(k, offset, copyable):
    """bf16 operands go to the kernel's 16-byte cp.async copy only with
    K % 8 == 0 and a 16-byte aligned base; others are converted first."""
    buf = torch.zeros(4 * k + 64, dtype=torch.bfloat16)
    base = (-buf.data_ptr() // 2) % 8          # elements to a 16-byte boundary
    t = buf[base + offset: base + offset + 4 * k].view(4, k)
    assert qm._copyable(t) is copyable


RESNET_CONVS = [(56, 64, 64, 1), (56, 64, 128, 2), (28, 128, 128, 1), (28, 128, 256, 2),
                (14, 256, 256, 1), (14, 256, 512, 2), (7, 512, 512, 1)]
EDGE_CONVS = [(15, 64, 64, 2), (15, 16, 32, 1), (9, 16, 80, 2), (7, 512, 512, 1),
              (8, 32, 32, 1), (1, 16, 16, 1), (2, 16, 16, 2), (224, 16, 16, 2),
              (33, 16, 96, 1)]


@pytest.mark.parametrize("h,cin,cout,stride", RESNET_CONVS + EDGE_CONVS)
def test_conv_tiles_cover_every_output_pixel_once(h, cin, cout, stride):
    """The kernel's blocks (image, tile, channel tile) cover each output
    pixel and channel exactly once, as the kernel maps a block's GEMM row r
    to pixel (oy0 + r // tw, ox0 + r % tw); each tile's patch holds its
    3x3 windows and fits in shared memory."""
    ho = wo = (h - 1) // stride + 1
    tile = qc.conv_tile(ho, wo, stride, cout)
    assert tile.bm in qc.TILE_MS and tile.bn in (64, 128)
    assert 1 <= tile.th * tile.tw <= tile.bm
    assert tile.smem_bytes(stride) <= qc.SMEM_LIMIT
    ph, pw = tile.halo(stride)
    assert (tile.th - 1) * stride + 2 < ph and (tile.tw - 1) * stride + 2 < pw
    tiles_x, tiles_y = -(-wo // tile.tw), -(-ho // tile.th)
    count = np.zeros((ho, wo), np.int32)
    for t in range(tiles_y * tiles_x):
        oy0, ox0 = (t // tiles_x) * tile.th, (t % tiles_x) * tile.tw
        for r in range(tile.th * tile.tw):
            oy, ox = oy0 + r // tile.tw, ox0 + r % tile.tw
            if oy < ho and ox < wo:
                count[oy, ox] += 1
    assert (count == 1).all()
    cols = np.zeros(cout, np.int32)
    for j in range(-(-cout // tile.bn)):
        cols[j * tile.bn:(j + 1) * tile.bn] += 1
    assert (cols == 1).all()


@pytest.mark.parametrize("h,cin,cout,stride", RESNET_CONVS)
def test_conv_tiles_keep_the_gemm_rows_busy(h, cin, cout, stride):
    """At ResNet-18's maps the chosen tiles fill at least 3/4 of their
    GEMM rows and stage at most 2.5x the input pixels they cover."""
    ho = (h - 1) // stride + 1
    tile = qc.conv_tile(ho, ho, stride, cout)
    tiles = -(-ho // tile.th) * -(-ho // tile.tw)
    assert ho * ho / (tiles * tile.bm) >= 0.75
    ph, pw = tile.halo(stride)
    assert tiles * ph * pw <= 2.5 * (h * h)


@pytest.mark.parametrize("name,index", [(name, i) for name, table in
                                        variants.KERNEL_VARIANTS.items()
                                        for i in range(len(table))])
def test_kernel_variant_patches_apply(name, index):
    """Each source variant that ops/kernels/variants.py times on the card
    (one phase of a kernel removed or changed) still patches the current
    source, so the measurement behind the kernels' notes can be repeated."""
    table = variants.KERNEL_VARIANTS[name]
    out = variants.patched_copy(name, index, table[index][1])
    text = "".join(p.read_text() for p in sorted(Path(out).iterdir()))
    for _, new in table[index][1]:
        assert new in text


def _mnv2_blocks():
    """(H, stride, Cin, hid, Cout, expand) of MobileNetV2's 17 blocks
    (tonylins topology, 224x224 input), with their uses per forward."""
    blocks, cin, hw = [], 32, 112
    for t, c, n, s in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                       (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)):
        for i in range(n):
            stride = s if i == 0 else 1
            blocks.append((hw, stride, cin, cin * t, c, t != 1))
            hw //= stride
            cin = c
    return blocks


MNV2_BLOCKS = _mnv2_blocks()
# the edges the kernel masks: a 15x15 map at stride 1 (ragged m16 rows of a
# whole-image tile), a 14x14 map at stride 2 with hid 144 and Cout 24
EDGE_BLOCKS = [(15, 1, 24, 144, 24, True), (14, 2, 24, 144, 24, True)]
BLOCKS = sorted(set(MNV2_BLOCKS)) + EDGE_BLOCKS


def _old_tile(ho):
    """The tile before block_tile: 8x8 output pixels, 4x4 below 8."""
    return 8 if ho >= 8 else 4


def _weight_bytes(cin, hid, cout, expand):
    return 2 * (cin * hid * expand + hid * cout)


@pytest.mark.parametrize("h,stride,cin,hid,cout,expand", BLOCKS)
def test_qblock_tiles_cover_every_output_and_channel_once(h, stride, cin, hid, cout,
                                                          expand):
    """The kernel's clusters (image, tile) cover each output pixel once, as
    the kernel maps a tile's project row r to pixel (oy0 + r // tw, ox0 +
    r % tw); the ranks' hid slices cover each hidden channel once and the
    ranks' epilogue rows each pixel of the tile once; a block's shared
    memory fits and its warps' project tiles fit their registers."""
    tile = qb.block_tile(h, h, stride, cin, hid, cout, expand)
    ho = wo = (h - 1) // stride + 1
    tiles_x = -(-wo // tile.tw)
    count = np.zeros((ho, wo), np.int32)
    for t in range(tile.tiles(ho, wo)):
        oy0, ox0 = (t // tiles_x) * tile.th, (t % tiles_x) * tile.tw
        assert oy0 < ho and ox0 < wo                  # no empty cluster
        for r in range(tile.th * tile.tw):
            oy, ox = oy0 + r // tile.tw, ox0 + r % tile.tw
            if oy < ho and ox < wo:
                count[oy, ox] += 1
    assert (count == 1).all()
    chans = np.zeros(hid, np.int32)
    rows = np.zeros(tile.th * tile.tw, np.int32)
    r_all = tile.th * tile.tw
    for rank, (lo, hi) in enumerate(tile.slices(hid)):
        assert lo < hi and lo % 16 == 0                  # every rank has work
        chans[lo:hi] += 1
        rows[rank * r_all // tile.cs:(rank + 1) * r_all // tile.cs] += 1
    assert (chans == 1).all() and (rows == 1).all()
    assert tile.cs in (1, 2, 4) and tile.hc in qb.CHUNKS
    assert (tile.warps, tile.maxt) in qb.LAUNCHES and tile.warp_tiles(cout) <= tile.maxt
    assert tile.smem_bytes(stride, cin, cout, expand) <= qb.SMEM_LIMIT


@pytest.mark.parametrize("h,stride,cin,hid,cout,expand", BLOCKS)
def test_qblock_tiles_cut_halo_and_weight_bytes(h, stride, cin, hid, cout, expand):
    """At batch 64 every block shape launches at least 128 blocks (the
    whole-image tiles one wave of one block on 128 of the 132 SMs, which
    on the card beats two waves of 256), expands no more input pixels
    (halo and ragged edge included) than the 8x8 / 4x4 tiles did, and from
    14x14 down stages fewer weight bytes per call (blocks x each block's
    slice) than the old tiles, which restaged all of w1 and w2 for every
    16-64 pixels."""
    tile = qb.block_tile(h, h, stride, cin, hid, cout, expand)
    ho = (h - 1) // stride + 1
    old = _old_tile(ho)
    old_tiles = (-(-ho // old)) ** 2
    old_halo = old_tiles * ((old - 1) * stride + 3) ** 2
    ph, pw = tile.halo(stride)
    assert B * tile.tiles(ho, ho) * tile.cs >= 128
    assert tile.tiles(ho, ho) * ph * pw <= old_halo
    if ho <= 14:
        staged = B * tile.tiles(ho, ho) * sum(
            _weight_bytes(cin, hi - lo, cout, expand) for lo, hi in tile.slices(hid))
        assert staged < B * old_tiles * _weight_bytes(cin, hid, cout, expand)


def test_qblock_weight_bytes_per_forward():
    """Over MobileNetV2's 17 blocks at batch 64 the weights staged per
    forward fall from about 1.0 GB (8x8 / 4x4 tiles) to under 0.3 GB."""
    old = new = 0
    for h, stride, cin, hid, cout, expand in MNV2_BLOCKS:
        ho = (h - 1) // stride + 1
        tile = qb.block_tile(h, h, stride, cin, hid, cout, expand)
        w = _weight_bytes(cin, hid, cout, expand)
        old += B * (-(-ho // _old_tile(ho))) ** 2 * w
        new += B * tile.tiles(ho, ho) * w
    assert 0.95e9 < old < 1.05e9
    assert new < 0.3e9


@pytest.mark.parametrize("s", [1, 50, 128, 129, 197, 256, 385])
def test_flash_grid_writes_every_query_row_once(s):
    """The kernel's blocks (groups of 16-row warps) write each query row of
    a (b, h) once and none past S; up to 208 rows (ViT-S/16's 197) one
    block holds them all, so K and V are read once per (b, h); the keys go
    in padded_len(S) / 128 steps of 128."""
    groups, warps, steps = at.flash_grid(s)
    assert 1 <= warps <= at.MAX_WARPS
    rows = np.zeros(s, np.int32)
    for grp in range(groups):
        for w in range(warps):
            r0 = (grp * warps + w) * at.ROWS_PER_WARP
            assert r0 < s or w > 0                      # no empty block
            rows[r0:min(s, r0 + at.ROWS_PER_WARP)] += 1
    assert (rows == 1).all()
    assert groups == -(-s // (at.ROWS_PER_WARP * at.MAX_WARPS))
    assert steps == at.padded_len(s) // at.BLOCK_K == -(-s // at.BLOCK_K)


# (batch, H, Cin, Cout, stride) of the 3x3 conv kernel: ResNet-18's seven
# shapes at batch 64 and 256, and the edges chip_smoke.py runs on the card
# (Cin 8, 16, 24, 72 straddle taps in a 64-wide chunk; odd H at stride 2;
# 1x1 and 2x2 maps; M not a multiple of 128; Cout 8 and 24)
QCONV_SHAPES = ([(b, h, cin, cout, s) for b in (B, 256) for h, cin, cout, s in RESNET_CONVS]
                + [(3, 9, 8, 8, 1), (5, 15, 16, 24, 2), (4, 7, 24, 32, 1),
                   (2, 10, 72, 64, 2), (3, 12, 72, 24, 1), (7, 1, 64, 64, 1),
                   (6, 2, 32, 16, 2), (5, 2, 64, 128, 1), (3, 28, 128, 128, 1),
                   (1, 15, 8, 1000, 2)])


@pytest.mark.parametrize("n,h,cin,cout,stride", QCONV_SHAPES)
def test_qconv3x3_tiles_cover_every_output_once(n, h, cin, cout, stride):
    """The kernel's grid, ceil(M / 128) x ceil(Cout / bn) blocks, covers
    each output pixel and channel exactly once with a width it is built
    for, no wider than Cout needs, and its shared memory fits a block."""
    ho = (h - 1) // stride + 1
    m = n * ho * ho
    tile = q3.conv_tile(m, cout)
    assert tile.bn in q3.TILE_NS
    assert tile.bn <= max(16, 1 << (cout - 1).bit_length())
    assert tile.smem_bytes(cin) <= SMEM_LIMIT
    rows = np.zeros(m, np.int32)
    for i in range(-(-m // q3.TILE_M)):
        assert i * q3.TILE_M < m                    # no block without outputs
        rows[i * q3.TILE_M:(i + 1) * q3.TILE_M] += 1
    cols = np.zeros(cout, np.int32)
    for j in range(-(-cout // tile.bn)):
        assert j * tile.bn < cout
        cols[j * tile.bn:(j + 1) * tile.bn] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert tile.bn <= 64 or tile.blocks(m, cout) <= 2 * q3.SMS


@pytest.mark.parametrize("shape,want", zip(RESNET_CONVS, [64, 64, 64, 128, 128, 128, 128]))
def test_qconv3x3_tile_widths_at_resnet18(shape, want):
    """At batch 64 the maps down to 28x28 (392 or more blocks at 128) take
    the 64-wide tile, three blocks an SM; from 28x28 / 2 down the 128-wide
    one (196 or 100 blocks), which gathers each input row for twice the
    channels: on the card the 7x7x512 conv is faster at 128 with 100
    blocks than at 64 with 200 (PERF.md section 6)."""
    h, cin, cout, stride = shape
    ho = (h - 1) // stride + 1
    assert q3.conv_tile(B * ho * ho, cout).bn == want


@pytest.mark.parametrize("cin", [8, 16, 24, 32, 40, 64, 72, 128, 256, 512])
def test_qconv3x3_chunks_gather_every_tap_channel_once(cin):
    """The implicit-im2col producer (sm90::ConvOperand) gathers K = 9*Cin
    in chunks of 64 columns, a 16-byte piece of 8 channels a thread: piece
    p of chunk k0 is column k = k0 + 8p, tap (dy, dx) = divmod(k // Cin, 3),
    channels k % Cin .. + 7.  Every (tap, channel) is gathered exactly once,
    no piece straddles two taps (Cin % 8 == 0), pieces past K are zero
    filled, and at Cin % 64 == 0 a chunk is one tap."""
    k_total = 9 * cin
    seen = np.zeros((9, cin), np.int32)
    for k0 in range(0, -(-k_total // 64) * 64, 64):
        taps = set()
        for piece in range(8):
            k = k0 + 8 * piece
            if k >= k_total:
                continue                            # zero filled
            tap, ci = divmod(k, cin)
            dy, dx = divmod(tap, 3)
            assert 0 <= dy < 3 and 0 <= dx < 3 and ci + 8 <= cin
            seen[tap, ci:ci + 8] += 1
            taps.add(tap)
        if cin % 64 == 0:
            assert len(taps) == 1
    assert (seen == 1).all()


@pytest.mark.parametrize("h,stride", [(56, 1), (56, 2), (15, 2), (7, 1), (2, 2), (1, 1)])
def test_qconv3x3_gather_reads_the_same_window(h, stride):
    """The producer reads output pixel (oh, ow)'s tap (dy, dx) at input
    (oh*s + dy - 1, ow*s + dx - 1) and zero fills outside the image: the
    3x3 SAME window of the convolution, at odd sizes and stride 2 too
    (checked against an unfold of the zero-padded input)."""
    x = torch.arange(h * h, dtype=torch.float32).reshape(1, 1, h, h) + 1
    ho = (h - 1) // stride + 1
    ref = torch.nn.functional.unfold(x, 3, padding=1, stride=stride)   # (9, ho*ho)
    got = torch.zeros(9, ho * ho)
    for m in range(ho * ho):
        oh, ow = divmod(m, ho)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            ih, iw = oh * stride + dy - 1, ow * stride + dx - 1
            if 0 <= ih < h and 0 <= iw < h:
                got[tap, m] = x[0, 0, ih, iw]
    assert torch.equal(got, ref[0])


RESNET_INT8_MATMULS = [(b * 28 * 28, 64, 128) for b in (B, 256)] + [
    (b * 14 * 14, 128, 256) for b in (B, 256)] + [
    (b * 7 * 7, 256, 512) for b in (B, 256)] + [(B, 512, 1000), (256, 512, 1000)]
EDGE_INT8_MATMULS = [(1, 100, 1000), (B, 72, 24), (1000, 100, 24), (1000, 72, 1000),
                     (B, 100, 1000), (1, 72, 24), (1, 8, 1), (129, 40, 17), (3, 1000, 8)]


@pytest.mark.parametrize("m,k,n", RESNET_INT8_MATMULS + EDGE_INT8_MATMULS)
def test_qmatmul_int8_tiles_cover_every_product_once(m, k, n):
    """The kernel's grid, ceil(M / bm) x ceil(N / bn) x splits blocks, gives
    every (m, n, k) of the product to exactly one block's split (rank z
    sums chunks [z * nch // splits, (z + 1) * nch // splits) of 32), no rank
    without a chunk, with a tile the kernel is built for: K split only over
    a cluster of at most 8 ranks of 64 x 64 tiles."""
    tile = q8.int8_tile(m, n, k)
    assert (tile.bm, tile.bn) in q8.TILES
    assert 1 <= tile.splits <= q8.MAX_SPLITS
    assert tile.splits == 1 or (tile.bm, tile.bn) == (64, 64)
    ks = np.zeros(k, np.int32)
    for z in range(tile.splits):
        chunks = tile.chunks(k, z)
        assert len(chunks) >= 1
        for c in chunks:
            ks[c * q8.CHUNK_K:(c + 1) * q8.CHUNK_K] += 1
    assert (ks == 1).all()
    rows = np.zeros(m, np.int32)
    for i in range(-(-m // tile.bm)):
        rows[i * tile.bm:(i + 1) * tile.bm] += 1
    cols = np.zeros(n, np.int32)
    for j in range(-(-n // tile.bn)):
        cols[j * tile.bn:(j + 1) * tile.bn] += 1
    assert (rows == 1).all() and (cols == 1).all()


@pytest.mark.parametrize("m,k,n", RESNET_INT8_MATMULS)
def test_qmatmul_int8_tiles_read_x_at_most_twice_and_fill_the_card(m, k, n):
    """At ResNet-18's shapes (batch 64 and 256) x is read and quantized
    once per column tile: once at N <= 256, at most twice at 512 (the fc's
    small x aside); every launch has at least 128 blocks, the fc at batch
    64 by splitting K 8 ways."""
    tile = q8.int8_tile(m, n, k)
    assert tile.blocks(m, n) >= q8.MIN_BLOCKS
    if n <= 512:
        assert -(-n // tile.bn) <= (1 if n <= 256 else 2)
    if (m, k, n) == (B, 512, 1000):
        assert tile.splits == 8 and tile.blocks(m, n) == 128


# (H, C, stride) of MobileNetV2's ten depthwise shapes, then the edges
# chip_smoke.py runs on the card: odd maps at both strides, 1x1 and 2x2,
# C = 8 and 24 (groups of one and of a single 8-channel vector), C = 40
# (a group of one at stride 2), and C = 12 (the C % 8 != 0 route)
MNV2_DW = [(112, 32, 1), (112, 96, 2), (56, 144, 1), (56, 144, 2), (28, 192, 1),
           (28, 192, 2), (14, 384, 1), (14, 576, 1), (14, 576, 2), (7, 960, 1)]
EDGE_DW = [(15, 24, 2), (9, 12, 1), (1, 32, 1), (2, 64, 2), (13, 72, 1), (8, 8, 2),
           (30, 40, 2), (15, 8, 1), (2, 24, 1), (1, 16, 2)]


@pytest.mark.parametrize("h,c,stride", MNV2_DW + EDGE_DW)
def test_dw_tile_covers_every_output_and_channel_once(h, c, stride):
    """The depthwise kernel's grid (tiles, channel groups) and its threads
    (csrc/qdwconv.cu: with t = 8 cg / VEC threads a pixel, channel vector
    cv = tid % t, tile row rt = tid / t, walking the row's 7-wide strips,
    VEC channels each) cover each output pixel and channel of an image
    exactly once, masked at the ragged edge; a block has at most 512
    threads and its halo fits shared memory.  The C % 8 != 0 route covers
    them with one thread per output value."""
    ho, wo = qd.out_hw(h, h, stride)
    tile = qd.dw_tile(h, h, c, stride)
    count = np.zeros((ho, wo, c), np.int32)
    if tile.cg == 0:
        assert c % 8
        for i in range(-(-ho * wo * c // qd.SIMPLE_THREADS) * qd.SIMPLE_THREADS):
            if i < ho * wo * c:
                pix, ch = divmod(i, c)
                count[pix // wo, pix % wo, ch] += 1
        assert (count == 1).all()
        return
    assert c % (8 * tile.cg) == 0 and tile.cg & (tile.cg - 1) == 0
    assert tile.tw % qd.SEG == 0 and 1 <= tile.threads() <= qd.MAX_THREADS
    assert tile.smem_bytes(stride) <= SMEM_LIMIT
    tpv = tile.cg * 8 // qd.VEC
    tiles_x, tiles_y = -(-wo // tile.tw), -(-ho // tile.th)
    for block in range(tiles_x * tiles_y):
        ty, tx = divmod(block, tiles_x)
        assert ty * tile.th < ho and tx * tile.tw < wo        # no empty block
        for grp in range(c // (8 * tile.cg)):
            for tid in range(tile.threads()):
                cv, rt = tid % tpv, tid // tpv
                oh = ty * tile.th + rt
                ch = grp * tile.cg * 8 + cv * qd.VEC
                ox0 = tx * tile.tw
                for ow0 in range(ox0, min(ox0 + tile.tw, wo), qd.SEG):
                    for j in range(qd.SEG):
                        ow = ow0 + j
                        if oh < ho and ow < wo:
                            count[oh, ow, ch:ch + qd.VEC] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape", MNV2_DW)
def test_dw_tile_at_mobilenet_v2(shape):
    """At MobileNetV2's shapes a tile divides the map (no ragged blocks), a
    stride-1 map takes whole groups of up to 64 channels and the 7x7 map is
    one tile; a launch has at least 4 blocks per SM at batch 64."""
    h, c, stride = shape
    ho, wo = qd.out_hw(h, h, stride)
    tile = qd.dw_tile(h, h, c, stride)
    assert ho % tile.th == 0 and wo % tile.tw == 0
    if ho == 7:
        assert (tile.th, tile.tw) == (7, 7)
    blocks = B * (ho // tile.th) * (wo // tile.tw) * (c // (8 * tile.cg))
    assert blocks >= 4 * SMS


def _dw_window_reads(n, h, c, stride, x_ids):
    """Mirror of csrc/qdwconv.cu for one image: stage each block's halo as
    the kernel does (piece i of the flattened (row, column, vector) range
    by the incremental row / remainder walk, zero where the tap is outside
    the image) into an array of shared-memory element slots, then read
    each thread's window (slot hs + dy * rstep + k * cstep of VEC channels,
    hs the strip's first halo column) as the sliding strip does; returns,
    per output pixel and channel, the 9 (dy, dx) input ids read."""
    ho, wo = qd.out_hw(h, h, stride)
    tile = qd.dw_tile(h, h, c, stride)
    hr, hc = tile.halo(stride)
    rp = tile.row_pitch(stride)
    tpv = tile.cg * 8 // qd.VEC
    threads = tile.threads()
    got = np.full((ho, wo, c, 9), -1, np.int64)
    tiles_x = -(-wo // tile.tw)
    for block in range(tiles_x * -(-ho // tile.th)):
        ty, tx = divmod(block, tiles_x)
        oy0, ox0 = ty * tile.th, tx * tile.tw
        for grp in range(c // (8 * tile.cg)):
            c0 = grp * tile.cg * 8
            smem = np.full(hr * rp * 8, -1, np.int64)        # bf16 slots
            per_row = hc * tile.cg
            for tid in range(threads):
                r, rem = divmod(tid, per_row)
                dr, drem = divmod(threads, per_row)
                while r < hr:
                    col, v = rem >> (tile.cg.bit_length() - 1), rem & (tile.cg - 1)
                    ih, iw = oy0 * stride - 1 + r, ox0 * stride - 1 + col
                    piece = r * rp + col * tile.cg + v
                    inside = 0 <= ih < h and 0 <= iw < h
                    smem[8 * piece:8 * piece + 8] = (
                        x_ids[n, ih, iw, c0 + 8 * v:c0 + 8 * v + 8] if inside else 0)
                    r, rem = r + dr, rem + drem
                    if rem >= per_row:
                        r, rem = r + 1, rem - per_row
            tpp = 8 // qd.VEC                           # threads a 16-byte piece
            rstep, cstep = rp * tpp, tile.cg * tpp
            for tid in range(threads):
                cv, rt = tid % tpv, tid // tpv
                oh = oy0 + rt
                if oh >= ho:
                    continue
                hrow = stride * rt * rstep + cv
                for ow0 in range(ox0, min(ox0 + tile.tw, wo), qd.SEG):
                    hs = hrow + stride * (ow0 - ox0) * cstep
                    for j in range(qd.SEG):
                        ow = ow0 + j
                        if ow >= wo:
                            continue
                        for t in range(9):
                            u = hs + (t // 3) * rstep + (stride * j + t % 3) * cstep
                            ch = c0 + cv * qd.VEC
                            got[oh, ow, ch:ch + qd.VEC, t] = smem[qd.VEC * u:qd.VEC * (u + 1)]
    return got


@pytest.mark.parametrize("h,c,stride", [(15, 24, 2), (13, 72, 1), (8, 8, 2), (14, 32, 1),
                                        (2, 64, 2), (1, 16, 1), (16, 16, 2)])
def test_dw_halo_and_window_read_the_same_window(h, c, stride):
    """What the kernel stages and reads for output (oh, ow) and channel ch
    is input (oh*s + dy - 1, ow*s + dx - 1, ch), zero outside the image:
    the 3x3 SAME window of the depthwise conv (checked against an unfold
    of the zero-padded input), for each of the nine taps in (dy, dx)
    order."""
    x_ids = np.arange(1, h * h * c + 1, dtype=np.int64).reshape(1, h, h, c)
    got = _dw_window_reads(0, h, c, stride, x_ids)
    ho, _ = qd.out_hw(h, h, stride)
    xt = torch.from_numpy(x_ids[0]).permute(2, 0, 1).double()[:, None]   # (C, 1, H, W)
    ref = torch.nn.functional.unfold(xt, 3, padding=1, stride=stride)    # (C, 9, L)
    ref = ref.reshape(c, 9, ho, ho).permute(2, 3, 0, 1).long().numpy()
    assert (got == ref).all()


STEM_SIZES = [224, 32, 40, 64]


@pytest.mark.parametrize("s", STEM_SIZES)
def test_stem_tile_covers_every_pooled_output_once(s):
    """The stem kernel's persistent blocks walk tiles t = (image, row,
    column) of stem_tile and write pooled (p0 + pp, q0 + qq) for item
    i = (pp * tq + qq) * 8 + octet, 8 channels each, masked past P: every
    pooled output and channel of an image exactly once; the pooling
    windows read conv rows and columns 2pp .. 2pp + 2 of the tile's
    (2tp + 1) x (2tq + 1) conv pixels, all inside it."""
    p = qs.stem_out_size(s)
    tile = qs.stem_tile(s)
    cr, cc = tile.conv()
    count = np.zeros((p, p, qs.COUT), np.int32)
    tiles_x, tiles_y = -(-p // tile.tq), -(-p // tile.tp)
    assert tile.tiles(s) == tiles_x * tiles_y
    for t in range(tile.tiles(s)):
        ty, tx = divmod(t, tiles_x)
        p0, q0 = ty * tile.tp, tx * tile.tq
        assert p0 < p and q0 < p                                  # no empty tile
        for i in range(tile.tp * tile.tq * 8):
            octet, pix = i & 7, i >> 3
            pp, qq = divmod(pix, tile.tq)
            assert 2 * pp + 2 < cr and 2 * qq + 2 < cc
            if p0 + pp < p and q0 + qq < p:
                count[p0 + pp, q0 + qq, 8 * octet:8 * octet + 8] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("cin", [1, 2, 3, 4])
def test_stem_tile_fits_shared_memory(cin):
    """A stem block's shared memory (weights, patch, fp32 conv tile) fits;
    at cin = 3 two blocks fit an SM (each with the 1 KB the card keeps a
    block), so the persistent grid is two blocks per SM."""
    tile = qs.stem_tile(224)
    assert tile.smem_bytes(cin) <= SMEM_LIMIT
    if cin == 3:
        assert 2 * (tile.smem_bytes(cin) + 1024) <= 228 * 1024


def _stem_patch(x, n, p0, q0, tile, pitch):
    """Mirror of the stem kernel's patch loader (csrc/qstem.cu: row_span,
    chunk_base, fetch, put) for one tile of float32 x (N, S, S, cin): each
    patch row is the element range e0 .. e0 + iw of x from input row
    4 p0 - 5 + pr and column 4 q0 - 5, read in 16-byte chunks aligned in x,
    zero outside the image's element range of that row."""
    nimg, s, _, cin = x.shape
    flat = x.reshape(-1)
    ir, ic = tile.patch()
    iw = ic * cin
    epc = 4
    nch = -(-iw // epc) + 1
    patch = np.zeros((ir, pitch), np.float32)
    for pr in range(ir):
        ih = 4 * p0 - 5 + pr
        rb = ((n * s) + ih) * s * cin
        e0 = rb + (4 * q0 - 5) * cin
        lo, hi = (max(e0, rb), min(e0 + iw, rb + s * cin)) if 0 <= ih < s else (0, 0)
        for j in range(nch):
            base = (e0 // epc) * epc + j * epc
            for t in range(epc):
                e, pe = base + t, base + t - e0
                if 0 <= pe < iw:
                    patch[pr, pe] = flat[e] if lo <= e < hi else 0.0
    return patch


@pytest.mark.parametrize("cin", [1, 3, 4])
def test_stem_koff_and_weight_order_read_the_conv_window(cin):
    """For every conv pixel (r, c) of a tile the kernel's A row, the patch
    words at 2r * pitch + 2c * cin + k_offsets[k] (a pair per even k),
    times the dy-major weight_matrix, is the plain 7x7/2 pad-3 conv of the
    image (float64, bf16 inputs and weights); the pairs never straddle a
    run, the padded taps read finite patch values under zero weights, and
    the weight matrix round-trips through weight_oihw."""
    rng = np.random.default_rng(cin)
    s, n = 40, 2
    x = rng.standard_normal((n, s, s, cin)).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float()
    w4 = torch.from_numpy(rng.standard_normal((64, cin, 7, 7)).astype(np.float32))
    w4 = w4.to(torch.bfloat16).float()
    wm = qs.weight_matrix(w4)
    assert wm.shape == (qs.k_pad(cin), 64)
    assert torch.equal(qs.weight_oihw(wm, cin), w4)
    ref = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2), w4.double(),
                                     stride=2, padding=3).permute(0, 2, 3, 1)
    tile = qs.stem_tile(s)
    cr, cc = tile.conv()
    pitch = tile.pitch(cin)
    assert pitch % 2 == 0 and pitch > tile.patch()[1] * cin
    koff = qs.k_offsets(cin, pitch)
    runp = qs.run_len(cin)
    for k in range(0, len(koff), 2):
        assert koff[k] % 2 == 0 and (k >= 7 * runp or koff[k + 1] == koff[k] + 1)
    conv = (s - 1) // 2 + 1
    p = qs.stem_out_size(s)
    for ti in range(-(-p // tile.tp)):
        for tj in range(-(-p // tile.tq)):
            p0, q0 = ti * tile.tp, tj * tile.tq
            patch = _stem_patch(x.numpy(), 1, p0, q0, tile, pitch).reshape(-1)
            a = np.zeros((cr * cc, len(koff)), np.float64)
            for m in range(cr * cc):
                r, c = divmod(m, cc)
                pb = 2 * r * pitch + 2 * c * cin
                for k in range(0, len(koff), 2):
                    a[m, k:k + 2] = patch[pb + koff[k]:pb + koff[k] + 2]
            assert np.isfinite(a).all()
            y = (a @ wm.double().numpy()).reshape(cr, cc, 64)
            cr0, cc0 = 2 * p0 - 1, 2 * q0 - 1
            for r in range(cr):
                for c in range(cc):
                    if 0 <= cr0 + r < conv and 0 <= cc0 + c < conv:
                        np.testing.assert_allclose(y[r, c], ref[1, cr0 + r, cc0 + c].numpy(),
                                                   rtol=1e-12, atol=1e-12)
