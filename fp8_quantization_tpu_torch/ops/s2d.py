"""Space-to-depth stem transform (exact re-indexing).

The port's own copy of ``fp8_quantization_tpu/ops/s2d.py`` (there lines
40-68; the port imports nothing of the JAX package).  The ResNet stem,
a 7x7 stride-2 conv with padding 3 on (N, H, W, C), equals a 4x4 stride-1
conv with padding ((2, 1), (2, 1)) on the block-2 space-to-depth input
(N, H/2, W/2, 4C), with the 7x7 kernel zero-padded to 8x8 at the top-left
and regrouped to (4, 4, 4C, F): out[p] = sum_u x[2p + u - 3] K[u], and
writing the input index as 2a + r gives K2[i, r] = K[2i + r - 1].

Both functions are pure re-indexing (the injected taps are exact zeros),
so they are bit-equal to JAX's and commute with per-channel weight
fake-quant over F: ``nn/layers.QuantConv`` applies the kernel transform
after the weight quantizer.  Layouts are JAX's (NHWC images, HWIO
kernels), so the tests compare them directly; the layer converts to
PyTorch's OIHW itself.
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/b, W/b, b*b*C), channel order (di, dj, c)."""
    n, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {block}")
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def s2d_stem_kernel(w: torch.Tensor):
    """Rearrange a (7, 7, C, F) stride-2 kernel for the s2d input.

    Returns (w2, strides, padding): w2 is (4, 4, 4C, F), its input channels
    in the order of ``space_to_depth``, for strides (1, 1) and padding
    ((2, 1), (2, 1)).
    """
    kh, kw, cin, f = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"s2d stem transform expects a 7x7 kernel, got "
                         f"{(kh, kw)}")
    # W2[i, di] = W[2i + di - 1]: one zero row and column in front (length
    # 8 = 2 * 4), then each spatial axis split into (tap, parity)
    wp = torch.nn.functional.pad(w, (0, 0, 0, 0, 1, 0, 1, 0))
    w2 = wp.reshape(4, 2, 4, 2, cin, f).permute(0, 2, 1, 3, 4, 5)
    return w2.reshape(4, 4, 4 * cin, f), (1, 1), ((2, 1), (2, 1))
