#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port, one cell a run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
It sets the deployed model up from the seed, runs the timed window,
with ``--trace 1`` profiles further batches for the per-layer metrics,
compares the window's logits with the plain reference, and prints one
JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, which also end standard error).  Without the devices, or with JAX
or the JAX package loaded, it exits non-zero and prints no result.
See benchmark/README.md.
"""

import argparse
import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (its start time in /proc, on the
    clock since boot), so that set-up counts the interpreter's start; 0
    where that cannot be read or reads implausibly."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0
    return age if 0.0 <= age < 60.0 else 0.0


T_START = time.monotonic() - _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness
    cell = harness.Cell(args.workload, harness.load_json(
        os.path.join(ROOT, "BENCHMARK.json")))
    harness.cache_environment(cell.name)
    return harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                           T_START)


if __name__ == "__main__":
    sys.exit(main())
