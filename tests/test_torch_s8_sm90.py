"""qmatmul_int8 on an s8 input with the Hopper kernel's epilogue
(csrc/qmatmul_s8_sm90.cu) against the JAX package (CPU).

* ``qmatmul_int8_plain`` (what the kernel computes, and what 'fused' runs
  on the CPU) with ``emit_s8`` against JAX's ``ops/int8.int8_matmul(
  x_prequant=True, act_fn=..., emit_s8=...)`` (gelu: JAX's exact form, as
  the ViT's), at signed and unsigned (asymmetric) weight grids and at 8
  and 4 input bits: bit-exact; its float32 and bfloat16 stores within
  rtol = atol = 2e-5 of JAX's (the integer sums exact on both sides).
* The kernel's tile rule (``s8_tile``), its persistent schedule
  (``s8_schedule``) covering every output once, its 128-byte K chunks
  covering K, and the shape rule (``sm90_takes``) that sends the ViT's
  head (M = batch) and K % 16 != 0 to the older s8 branch.
* The op ``fp8tpu::qmatmul_int8`` with the emission arguments
  (``torch.library.opcheck``) and the config's checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.nn.activations import ACTIVATIONS as JACT
from fp8_quantization_tpu.ops import int8 as jint8
from fp8_quantization_tpu_torch.ops import int8 as tint8
from fp8_quantization_tpu_torch.ops.kernels import qmatmul_int8 as qm
from fp8_quantization_tpu_torch.ops.kernels.common import SMS

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _operands(seed, m, k, n, signed, a_bits):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 2, (m, k)).astype(np.float32)
    wsg = rng.randint(-128 if not signed else -127, 128, (k, n)).astype(np.int8)
    w_delta = rng.uniform(0.01, 0.1, n).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    shift = (rng.standard_normal(n) * 0.1).astype(np.float32)
    a_delta, a_zero = np.float32(0.05), np.float32(127.6 if a_bits == 8 else 7.4)
    xs8 = np.asarray(jint8.prequant_s8(jnp.asarray(x), a_delta, a_zero, float(a_bits)))
    return xs8, wsg, w_delta, np.float32(signed), a_delta, a_zero, scale, shift


def _port_args(xs8, wsg, w_delta, sgn, a_delta, a_zero, scale, shift):
    t = torch.from_numpy
    return (t(xs8), t(np.ascontiguousarray(wsg.T)), t(w_delta),
            torch.tensor([0.0, float(sgn)]), torch.tensor([a_delta, a_zero, 0.0]),
            t(scale), t(shift))


@pytest.mark.parametrize("act", [None, "relu", "gelu"])
@pytest.mark.parametrize("a_bits", [8, 4])
@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_plain_emit_s8_bit_exact_against_jax(signed, a_bits, act):
    """The ViT's mlp1 as the kernel computes it: the emitted s8 operand of
    the next consumer equals JAX's element for element (ragged M, N and a
    K that is no multiple of the kernel's 128-byte chunk).  The integer
    sums and the float epilogue are the same operations; gelu's float
    values differ from JAX's by an ulp at up to a third of these outputs
    (torch's erfc against XLA's), none of them across a rounding boundary
    of the emission grid."""
    ops = _operands(10 + 2 * signed + a_bits, 37, 80, 56, signed, a_bits)
    xs8, wsg, w_delta, sgn, a_delta, a_zero, scale, shift = ops
    nd, nz = np.float32(0.03), np.float32(100.2)
    ref = jint8.int8_matmul(jnp.asarray(xs8), jnp.asarray(wsg), jnp.asarray(w_delta),
                            jnp.float32(sgn), a_delta, a_zero, float(a_bits),
                            scale=jnp.asarray(scale), shift=jnp.asarray(shift),
                            act_fn=JACT.get(act), x_prequant=True,
                            emit_s8=(nd, nz, 8.0))
    cfg = qm.Int8MatmulConfig(activation=act, act_n_bits=a_bits, emit_bits=8)
    before = qm.fused_quant_matmul_int8.launches
    out = qm.fused_quant_matmul_int8(*_port_args(*ops), cfg=cfg,
                                     e_scalars=torch.tensor([nd, nz])).numpy()
    assert out.dtype == np.int8 and out.shape == (37, 56)
    assert qm.fused_quant_matmul_int8.launches == before     # CPU: the plain version
    assert len(np.unique(out)) > 20      # not all on one grid point
    np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("out_bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "gelu"])
def test_plain_float_stores_match_jax(act, out_bf16):
    """The float32 and bfloat16 (conv_out_bf16) stores, with and without
    gelu, against JAX's int8_matmul(x_prequant=True)."""
    ops = _operands(3, 29, 48, 40, True, 8)
    xs8, wsg, w_delta, sgn, a_delta, a_zero, scale, shift = ops
    ref = jint8.int8_matmul(jnp.asarray(xs8), jnp.asarray(wsg), jnp.asarray(w_delta),
                            jnp.float32(sgn), a_delta, a_zero, 8.0,
                            scale=jnp.asarray(scale), shift=jnp.asarray(shift),
                            act_fn=JACT.get(act), x_prequant=True,
                            out_bf16=out_bf16)
    out = qm.fused_quant_matmul_int8(
        *_port_args(*ops), cfg=qm.Int8MatmulConfig(activation=act, out_bf16=out_bf16))
    assert out.dtype == (torch.bfloat16 if out_bf16 else torch.float32)
    np.testing.assert_allclose(out.to(torch.float32).numpy(),
                               np.asarray(ref, np.float32), **TOL)


# (M, K, N): the ViT-S/16 INT8 block's four products at batch 64 (qkv, proj,
# mlp2, mlp1), at batch 128, then ragged and small shapes
SHAPES = [(12608, 384, 1152), (12608, 384, 384), (12608, 1536, 384), (12608, 384, 1536),
          (25216, 384, 1152), (1000, 80, 200), (128, 16, 8), (700, 1024, 1000),
          (129, 400, 257)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_s8_tiles_and_schedule_cover_every_output_once(m, k, n):
    """One persistent block per SM at most, each taking tiles b, b +
    blocks, ...: every (m, n) output in exactly one 128 x BN tile of one
    block, no block idle, blocks' tile counts within one of each other,
    each block on one column tile where the grid is a multiple of the
    column tiles (its colsum summed once); the 128-byte chunks cover K once
    (TMA zero-fills past K)."""
    bn = qm.s8_tile(m, n)
    assert bn in qm.S8_WIDTHS
    sched = qm.s8_schedule(m, n)
    assert 1 <= len(sched) <= SMS and all(sched)
    counts = [len(t) for t in sched]
    assert max(counts) - min(counts) <= 1
    tiles_n = -(-n // bn)
    if len(sched) % tiles_n == 0:     # each block keeps one column tile
        assert all(len({n0 for _, n0 in tiles}) == 1 for tiles in sched)
    assert qm.s8_blocks(sum(counts), tiles_n) == len(sched)
    cover = np.zeros((m, n), np.int32)
    for tiles in sched:
        for m0, n0 in tiles:
            assert m0 % qm.S8_BM == 0 and n0 % bn == 0 and m0 < m and n0 < n
            cover[m0:m0 + qm.S8_BM, n0:n0 + bn] += 1
    assert (cover == 1).all()
    ks = np.zeros(k, np.int32)
    for c in range(-(-k // qm.S8_BK)):
        ks[c * qm.S8_BK:(c + 1) * qm.S8_BK] += 1
    assert (ks == 1).all()


def test_s8_tile_widths_at_the_vit_shapes():
    """The rule's widths at the ViT's shapes and what it weighs: qkv (N =
    1,152) at 192 (6 column tiles, 132 blocks, 5 waves of 192 columns
    against 8 of 128 over 126 blocks), proj and mlp2 (N = 384) at 128 (3
    waves of 128 against 2 of 192: a tie, which goes to the narrower),
    mlp1 (N = 1,536) at 128 (12 column tiles, 9 waves against 7 of 192 over
    128 blocks); 12,608 rows are 98.5 tiles, the last one ragged."""
    assert qm.s8_tile(12608, 1152) == 192
    assert qm.s8_tile(12608, 384) == 128
    assert qm.s8_tile(12608, 1536) == 128
    assert qm.s8_tile(12608, 1000) == 256       # 4 column tiles, 3 waves
    assert [len(qm.s8_schedule(12608, n)) for n in (1152, 384, 1536)] == [132] * 3
    assert sum(map(len, qm.s8_schedule(12608, 1152))) == 99 * 6


def test_shape_rule_sends_the_head_and_odd_k_to_the_older_branch():
    """sm90_takes: a full 128-row tile, K % 16 == 0 (TMA's row stride) and
    K <= 16,384 (the exact int32 total); the ViT's head (M = 64 at batch
    64) and a K of 72 take csrc/qmatmul_int8.cu's s8 branch, whose rule is
    K % 4 == 0."""
    assert qm.sm90_takes(12608, 384) and qm.sm90_takes(128, 16)
    assert not qm.sm90_takes(64, 384)            # the head at batch 64
    assert not qm.sm90_takes(127, 384)
    assert not qm.sm90_takes(12608, 72) and qm.s8_input_ok(72)
    assert qm.sm90_takes(1000, 16384) and not qm.sm90_takes(1000, 16400)


def test_config_takes_gelu_and_the_emission():
    """gelu, bfloat16 and s8 out mark a config as the Hopper kernel's
    only; other activations and grids still raise; e_scalars and
    emit_bits go together."""
    assert not qm.Int8MatmulConfig(activation="relu6").sm90_only
    for cfg in (qm.Int8MatmulConfig(activation="gelu"),
                qm.Int8MatmulConfig(out_bf16=True), qm.Int8MatmulConfig(emit_bits=4)):
        assert cfg.sm90_only
    with pytest.raises(ValueError, match="activation"):
        qm.Int8MatmulConfig(activation="tanh")
    with pytest.raises(ValueError, match="emit_bits"):
        qm.Int8MatmulConfig(emit_bits=9)
    x = torch.zeros(4, 16, dtype=torch.int8)
    args = (x, torch.zeros(3, 16, dtype=torch.int8), torch.ones(3), torch.tensor([0.0, 1.0]),
            torch.tensor([0.1, 128.0, 0.0]), torch.ones(3), torch.zeros(3))
    with pytest.raises(ValueError, match="go together"):
        qm.qmatmul_int8_plain(*args, qm.Int8MatmulConfig(emit_bits=8))
    with pytest.raises(ValueError, match="go together"):
        qm.qmatmul_int8_plain(*args, qm.Int8MatmulConfig(), torch.tensor([0.1, 3.0]))
    with pytest.raises(ValueError, match="go together"):
        qm.fused_quant_matmul_int8(*args, cfg=qm.Int8MatmulConfig(),
                                   e_scalars=torch.tensor([0.1, 3.0]))


@pytest.mark.parametrize("case", ["emit", "bf16"])
def test_op_schema_takes_the_emission_arguments(case):
    """fp8tpu::qmatmul_int8 (ops/kernels/library.py) takes e_scalars,
    e_bits and out_bf16: its fake and CPU implementation agree
    (torch.library.opcheck) on the int8 and bfloat16 outputs."""
    x = torch.randint(-128, 128, (5, 16), dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 16), dtype=torch.int8)
    base = (x, w, torch.full((3,), 0.1), torch.tensor([0.0, 1.0]),
            torch.tensor([0.05, 128.0, 0.0]), torch.ones(3), torch.zeros(3))
    if case == "emit":
        args = base + ("gelu", 8, 8, torch.tensor([0.2, 120.0]), 6, False)
        want = torch.int8
    else:
        args = base + ("relu", 8, 8, None, 8, True)
        want = torch.bfloat16
    torch.library.opcheck(torch.ops.fp8tpu.qmatmul_int8.default, args)
    assert torch.ops.fp8tpu.qmatmul_int8(*args).dtype == want
    # the emission grid's bits reach the plain version: 6 bits clip at 63 - 128
    if case == "emit":
        assert int(torch.ops.fp8tpu.qmatmul_int8(*args).max()) <= 63 - 128
    # prequant_s8 of the float result is the emission
    if case == "emit":
        y = torch.ops.fp8tpu.qmatmul_int8(*base, "gelu", 8, 8)
        np.testing.assert_array_equal(
            torch.ops.fp8tpu.qmatmul_int8(*args).numpy(),
            tint8.prequant_s8(y, torch.tensor(0.2), torch.tensor(120.0), 6).numpy())
