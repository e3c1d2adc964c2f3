#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 [--control 3]

For each seed it sets the cell up as a run does, drives the check's number
of batches (``harness.CHECK_BATCHES``, at the cell's batch size) through the timed
forward, and prints one JSON line with the compared numbers (``check.py``)
of the program; of the two faults an inference cell can have, each applied
to those logits (``half``: the second half of each batch replaced by the
mean of the first; ``altered``: one image's logits moved by one class);
and, for the first ``--control`` seeds, of the control: the reference
computed on the ``e4m3`` datapath (``reference/quant.py``) in the
program's place.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def half_batch(y):
    """The second half of a batch's logits replaced by the mean of the
    first half's."""
    y = y.clone()
    h = y.shape[0] // 2
    y[h:] = y[:h].mean(dim=0)
    return y


def altered(y):
    """The first image's logits moved by one class."""
    y = y.clone()
    y[0] = y[0].roll(1)
    return y


FAULTS = {"half": half_batch, "altered": altered}


def readings(run, control: bool) -> dict:
    """The numbers of one set-up run (``harness.Run``) and its faults, and
    with ``control`` of the control."""
    import torch

    from benchmark import check
    k = run.check_batches
    with torch.no_grad():
        outs = [run.forward(run.pool[i % len(run.pool)]).cpu() for i in range(k)]
    run.release()
    x = torch.cat([run.pool[i % len(run.pool)] for i in range(k)])
    cfg, sd, mbits = run.config, run.sd, run.args.fp8_mantissa_bits
    ref = check.logits(check.reference_model(cfg, sd, mbits), run.cal, x)
    wide = check.logits(check.reference_model(cfg, sd, mbits, wide=True), run.cal, x)
    out = {"seed": run.seed,
           "program": check.numbers(torch.cat(outs).to(ref.device), ref, wide)}
    out["faults"] = {name: check.numbers(torch.cat([f(y) for y in outs]).to(ref.device),
                                         ref, wide)
                     for name, f in FAULTS.items()}
    if control:
        low = check.logits(check.reference_model(cfg, sd, mbits, "e4m3"), run.cal, x)
        out["control"] = check.numbers(low, ref, wide)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", type=int, default=3,
                   help="read the control on this many of the seeds")
    args = p.parse_args(argv)

    import torch

    from benchmark import harness
    cell = harness.Cell(args.workload, harness.load_json(
        os.path.join(ROOT, "BENCHMARK.json")))
    harness.cache_environment(cell.name)
    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 3
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell, seed, 0.0, "cuda")
        run.setup()
        line = readings(run, i < args.control)
        line["setup_s"] = run.times["setup_s"]
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
