"""Cells cut to a size the CPU runs in seconds, for the tests: two-image
batches, a pool of two, 32x32 images, two calibration images, one batch
profiled and checked."""

from benchmark import harness


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.Cell(name, harness.load_json(harness.ROOT / "BENCHMARK.json"))
    cell.traffic = dict(cell.traffic, batch=2, pool=2,
                        images=dict(cell.traffic["images"], size=32))
    cell.config = dict(cell.config, calibration_images=2)
    return cell


def tiny_run(name: str, traced: bool = False, seed: int = 2 ** 33 + 5,
             seconds: float = 0.5, forward=None) -> dict:
    """``harness.drive`` of the tiny cell on the CPU; ``forward`` replaces
    the timed path's forward (a fault)."""
    harness.cache_environment("cpu-tests")
    run = harness.Run(tiny_cell(name), seed, seconds, "cpu")
    run.profile_batches = run.check_batches = 1
    if forward is not None:
        run.forward = forward.__get__(run)
    return harness.drive(run, traced)
