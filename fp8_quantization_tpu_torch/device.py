"""Device selection for the port's entry points.

No JAX counterpart: JAX picks its platform globally.  Here every entry point
takes an explicit ``device`` that defaults to the card, and asking for the
card where there is none raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``torch.device`` for an entry point; raises if CUDA is asked for but
    missing (the caller must pass ``device="cpu"`` to run on the host)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the port on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
