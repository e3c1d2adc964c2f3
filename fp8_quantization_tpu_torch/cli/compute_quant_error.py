"""The analytical SQNR study's entry point (BASELINE config 1).

Mirrors ``cli/compute_quant_error.py``: the same flags and the same
table, with ``--device {cuda,cpu}`` in place of JAX's ``--cpu`` (the
card by default; without CUDA it raises unless given ``--device cpu``).

    python -m fp8_quantization_tpu_torch.cli.compute_quant_error \\
        --device cpu --n-samples 200000 --num-candidates 120
"""

from __future__ import annotations

import argparse
import logging
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="compute_quant_error",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--n-samples", type=int, default=5_000_000)
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--num-candidates", type=int, default=1000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None):
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "INFO"))
    args = build_parser().parse_args(argv)
    from fp8_quantization_tpu_torch.analytical.study import run_full_study
    from fp8_quantization_tpu_torch.device import resolve_device
    return run_full_study(n_samples=args.n_samples, seed=args.seed,
                          num_candidates=args.num_candidates,
                          device=resolve_device(args.device))


if __name__ == "__main__":
    main()
