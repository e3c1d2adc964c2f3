"""Flash attention for the quantized ViT: ``softmax(q k^T * sm_scale) v``.

Mirrors ``flash_mha`` of ``fp8_quantization_tpu/ops/pallas/attention.py``
(line 43), which wraps jax.experimental's Pallas TPU flash-attention kernel
(``jax/experimental/pallas/ops/tpu/flash_attention.py``).  The kernel is
``csrc/flash_mha.cu``: one block per (batch, head, query group) of up to 13
warps of 16 query rows (``flash_grid``), so each (b, h)'s K and V of
ViT-S/16 are read once; the keys in steps of 128 as the Pallas kernel
takes them, both products on the tensor cores (``mma.sync``, bf16, fp32
sums), the scores, p and the accumulator in registers, the softmax
statistics in fp32.  It is bound by bytes at ViT-S/16's shapes (see the
note in the source).

The public layout is JAX's: ``(B, H, S, D)`` in, float32 ``(B, H, S, D)``
out.  The plain version follows the Pallas kernel's arithmetic, not the
textbook formula:

* q, k and v are rounded to bf16;
* ``s = dot_f32(q, k) * sm_scale`` (the scale after the product);
* S is padded to ``padded_len(S)`` (a multiple of 128, at least 128) and the
  pad keys are masked, so they add exactly 0; pad query rows are dropped;
* one key block (``padded_len(S) == 128``): ``p = exp(s - m)``,
  ``p /= sum(p)``, then ``dot(bf16(p), v)``;
* more blocks: an online softmax over blocks of 128 keys, ``m`` and ``l`` in
  fp32 from ``-inf`` and 0, ``p = exp(s - m_next)`` rounded to bf16
  unnormalized, ``acc *= l_corr * (1 / l_next)`` and then ``acc +=
  dot(bf16(p), v) * (1 / l_next)``;
* the output is rounded to bf16 and returned as float32.

The wrapper reads q, k and v through their strides (the last one must be
1, the others and the data 16-byte aligned for the kernel's vector loads),
so the model hands it views of the qkv output without copies; on the
card the result is a ``(B, H, S, D)`` view of a ``(B, S, H, D)`` buffer,
which the projection after it reads as ``(B*S, H*D)`` without a copy.
"""

from __future__ import annotations

import torch

from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.ops.kernels.common import on_card, stream_ptr

REPLACES = "fp8_quantization_tpu/ops/pallas/attention.py:43"
BLOCK_K = 128                   # keys per step, the Pallas kernel's block_k
HEAD_DIM = 64                   # the head width the CUDA kernel is built for
                                # (ViT-S/B/L alike)
ROWS_PER_WARP = 16              # query rows of one warp (an m16 tile)
MAX_WARPS = 13                  # warps of one block (csrc/flash_mha.cu)


def padded_len(s: int) -> int:
    """The sequence length the Pallas wrapper pads to."""
    return max(BLOCK_K, -(-s // BLOCK_K) * BLOCK_K)


def flash_grid(s: int) -> tuple[int, int, int]:
    """(query groups, warps per group, key steps) of the kernel at sequence
    length ``s``: the fewest groups of at most ``MAX_WARPS`` warps of 16
    rows that hold the ``s`` query rows, the warps spread evenly over them
    (one group up to 208 rows: K and V read once per (b, h)); the keys in
    ``padded_len(s) / 128`` steps."""
    tiles = -(-s // ROWS_PER_WARP)
    groups = -(-tiles // MAX_WARPS)
    return groups, -(-tiles // groups), padded_len(s) // BLOCK_K


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (CPU tests, card reference);
    float32 ``(B, H, S, D)``."""
    s_len = q.shape[2]
    qb, kb, vb = (_bf16(t) for t in (q, k, v))
    scale = torch.tensor(sm_scale, dtype=torch.float32, device=q.device)
    if padded_len(s_len) == BLOCK_K:
        s = (qb @ kb.transpose(-1, -2)) * scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        return _bf16(_bf16(p) @ vb)
    m = torch.full((*q.shape[:3], 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, device=q.device)
    for k0 in range(0, s_len, BLOCK_K):
        s = (qb @ kb[:, :, k0:k0 + BLOCK_K].transpose(-1, -2)) * scale
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0, 1.0, 1.0 / l_next)
        acc = acc * (l_corr * inv)
        acc = acc + (_bf16(p) @ vb[:, :, k0:k0 + BLOCK_K]) * inv
        m, l = m_next, l_next
    return _bf16(acc)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              sm_scale: float) -> torch.Tensor:
    """softmax(q k^T * sm_scale) v for (B, H, S, D) float32 or bf16 operands
    (any strides with the last one 1); float32 (B, H, S, D), a view of a
    (B, S, H, D) tensor.  Calls the op ``fp8tpu::flash_mha``
    (ops/kernels/library.py): CPU tensors take ``flash_mha_plain``; CUDA
    tensors launch the kernel (``flash_mha_cuda``)."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, H, S, D) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return torch.ops.fp8tpu.flash_mha(q, k, v, float(sm_scale)).permute(
        0, 2, 1, 3)


def flash_mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   sm_scale: float) -> torch.Tensor:
    """The kernel's launch on CUDA tensors (op ``fp8tpu::flash_mha``,
    ops/kernels/library.py): float32 (B, S, H, D); raises where it cannot
    launch."""
    on_card(q, k, v)
    b, h, s, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_mha on the card takes head width "
                         f"{HEAD_DIM}, got {d}")
    if {t.dtype for t in (q, k, v)} not in ({torch.float32}, {torch.bfloat16}):
        raise TypeError("q, k, v must all be float32 or all bfloat16")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous along D")
    vec = 16 // q.element_size()        # elements of one 16-byte load
    if any(t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3])
           for t in (q, k, v)):
        raise ValueError("flash_mha on the card reads 16-byte vectors: q, k, "
                         "v data and their (B, H, S) strides must be 16-byte "
                         "aligned")
    groups, warps, _ = flash_grid(s)
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    err = build.entry("flash_mha")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        int(q.dtype == torch.bfloat16), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], out.data_ptr(), b, h, s, d, groups, warps,
        float(sm_scale), stream_ptr(q))
    build.check(err, "flash_mha")
    flash_mha.launches += 1
    return out


flash_mha.launches = 0
