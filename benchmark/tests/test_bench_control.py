"""The control of each cell's check at the cell's own size, on the GPU:
three seeds of the program pass the cell's limits and the control (the
reference on the e4m3 datapath in the program's place) fails them on every
seed.  The same at a CPU size in ``test_bench_reference.py``."""

import pytest

from benchmark import check, harness, readings

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(card, cell):
    import torch
    c = harness.Cell(cell, harness.load_json(harness.ROOT / "BENCHMARK.json"))
    harness.cache_environment(cell)
    limits = c.spec["limits"]
    for seed in (2 ** 32 + 11, 2 ** 32 + 12, 2 ** 32 + 13):
        run = harness.Run(c, seed, 0.0, card)
        run.setup()
        out = readings.readings(run, control=True)
        assert check.verdict(out["program"], limits)[0], out
        assert not check.verdict(out["control"], limits)[0], out
        for fault in out["faults"].values():
            assert not check.verdict(fault, limits)[0], out
        del run
        torch.cuda.empty_cache()
