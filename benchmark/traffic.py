"""The general generator of the traffic mixes (``benchmark/traffic/*.json``).

A mix is offline classification: the window's one client sends batches
of ``batch`` images back to back (a closed loop), each drawn from a pool
of ``pool`` distinct batches made from the seed.  The images are
synthetic, NHWC float32 at ``images.size``: a coarse random pattern of side
``images.coarse`` (N(0, ``coarse_std``^2) per pixel and channel), upsampled
bilinearly, plus per-pixel noise N(0, ``noise_std``^2): structured at
several scales, as normalized photographs are.  Every stream of images is
drawn on the device by its own ``torch.Generator``, seeded from the run's
seed and the stream's name, so one seed gives the same images on every
run, and the calibration batches, the pool and any other stream differ.
"""

from __future__ import annotations

import hashlib

import torch
import torch.nn.functional as F


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` from the run's ``seed`` (any integer)."""
    digest = hashlib.sha256(f"{seed}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def images(spec: dict, n: int, g: torch.Generator, device) -> torch.Tensor:
    """``n`` images (n, size, size, 3) float32 on ``device``."""
    size, coarse = spec["size"], spec["coarse"]
    low = torch.randn(n, 3, coarse, coarse, generator=g, device=device)
    x = F.interpolate(low * spec["coarse_std"], size=(size, size),
                      mode="bilinear", align_corners=False)
    x = x + spec["noise_std"] * torch.randn(n, 3, size, size, generator=g,
                                            device=device)
    return x.permute(0, 2, 3, 1).contiguous()


def pool(traffic: dict, seed: int, device) -> list:
    """The mix's pool of distinct batches."""
    g = generator(seed, "pool", device)
    return [images(traffic["images"], traffic["batch"], g, device)
            for _ in range(traffic["pool"])]
