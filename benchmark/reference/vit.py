"""Plain reference of the quantized ViT (Dosovitskiy et al.,
arXiv:2010.11929; timm's ``vit_small_patch16_224`` layout), FP8
post-training quantization, float32.

Takes a state dict in timm's key layout (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,
norm2,mlp.fc1,mlp.fc2}``, ``norm``, ``head``).  The patch embedding is a
conv with bias and an output quant; the cls token and the position
embedding are added unquantized; each pre-norm block runs

    h = Q(LN1(x)),  qkv = Q(h Wqkv + b),  a = softmax(q k^T / sqrt(d)) v,
    x = Q(x + Q(a Wproj + b)),  h = Q(LN2(x)),
    x = Q(x + Q(Q(gelu(h W1 + b1)) W2 + b2))

with every weight (the LayerNorm gammas among them) on its per-channel FP8
grid, LayerNorm's statistics as sums over the count with eps 1e-5 (the
port's, where timm has 1e-6), the exact gelu; then Q(LN(x)) of the cls row
and the quantized head.  ``quant.Quant`` says how each product's operands
(the attention's q, k, v and probabilities among them) are held.  This
module imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.quant import Quant, float32_products

LN_EPS = 1e-5


class ViT:
    def __init__(self, sd: dict, heads: int, mbits: int = 4,
                 datapath: str = "bf16", wide: bool = False):
        self.sd = {k: v.to(torch.float32) for k, v in sd.items()}
        self.heads = heads
        self.q = Quant(mbits, datapath, wide)
        self.depth = len({k.split(".")[1] for k in self.sd
                          if k.startswith("blocks.")})

    def _ln(self, x, prefix):
        n = x.shape[-1]
        mean = x.sum(dim=-1, keepdim=True) / n
        xc = x - mean
        var = (xc * xc).sum(dim=-1, keepdim=True) / n
        gamma = self.q.weight(prefix, self.sd[f"{prefix}.weight"])
        return self.q.act(prefix, xc * torch.rsqrt(var + LN_EPS) * gamma
                          + self.sd[f"{prefix}.bias"])

    def _linear(self, x, prefix, on_grid=True, gelu=False):
        q = self.q
        w = q.operand(q.weight(prefix, self.sd[f"{prefix}.weight"]), True, 0)
        y = q.matmul(q.operand(x, on_grid), w.t()) + self.sd[f"{prefix}.bias"]
        if gelu:
            y = 0.5 * y * torch.special.erfc(-y * math.sqrt(0.5))
        return q.act(prefix, y)

    def _attention(self, h, prefix):
        q = self.q
        b, n, d = h.shape
        hd = d // self.heads
        qkv = self._linear(h, f"{prefix}.qkv").reshape(b, n, 3, self.heads, hd)
        qh, kh, vh = (q.operand(qkv[:, :, i].transpose(1, 2), attention=True)
                      for i in range(3))
        s = q.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
        p = torch.softmax(s, dim=-1)
        a = q.matmul(q.operand(p, attention=True), vh).transpose(1, 2).reshape(b, n, d)
        return self._linear(a, f"{prefix}.proj", on_grid=False)

    def _forward(self, images):
        """``images`` NHWC float32 -> logits (N, classes)."""
        q, sd = self.q, self.sd
        w = q.operand(q.weight("patch_embed.proj", sd["patch_embed.proj.weight"]),
                      True, 0)
        p = w.shape[-1]
        x = q.conv2d(q.operand(images.permute(0, 3, 1, 2)), w, stride=p)
        x = x + sd["patch_embed.proj.bias"][:, None, None]
        x = q.act("patch_embed.proj", x).flatten(2).transpose(1, 2)
        b = x.shape[0]
        x = torch.cat([sd["cls_token"].expand(b, 1, -1), x], dim=1) + sd["pos_embed"]
        for i in range(self.depth):
            t = f"blocks.{i}"
            x = q.act(f"{t}.res1", x + self._attention(self._ln(x, f"{t}.norm1"),
                                                      f"{t}.attn"))
            h = self._linear(self._ln(x, f"{t}.norm2"), f"{t}.mlp.fc1", gelu=True)
            x = q.act(f"{t}.res2", x + self._linear(h, f"{t}.mlp.fc2"))
        return self._linear(self._ln(x, "norm")[:, 0], "head")

    @torch.no_grad()
    def calibrate(self, images):
        self.q.calibrating = True
        try:
            with float32_products():
                self._forward(images)
        finally:
            self.q.calibrating = False

    @torch.no_grad()
    def __call__(self, images):
        with float32_products():
            return self._forward(images)


def build(model: dict, sd: dict, mbits: int, datapath: str = "bf16",
          wide: bool = False) -> ViT:
    """The reference of a configuration's ``model``."""
    return ViT(sd, model["heads"], mbits, datapath, wide)
