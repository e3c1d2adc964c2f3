"""A tiny run on the CPU through the harness (``tests/tiny.py``): the last
line's keys, the traced run's keys, the exits without a card or without
the port; and the faults an inference cell can have, planted in the timed
path, each turning ``correct`` false."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, readings
from benchmark.tests.tiny import tiny_run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(cell, traced):
    result = tiny_run(cell, traced=traced)
    want = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(result) == want
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for v in result["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(result)
    assert result["correct"] is True and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(readings.FAULTS))
def test_fault_turns_correct_false(cell, fault):
    """The timed path broken underneath: ``half`` leaves out half of each
    batch (its rows the mean of the rest), ``altered`` changes one answer
    where it is produced."""
    broken = readings.FAULTS[fault]

    def forward(self, x):
        return broken(self.model(x, mode="fixed", quant_w=self.quant_w, quant_a=True))

    assert tiny_run(cell, forward=forward)["correct"] is False


def test_logits_not_finite_fail():
    """A batch whose logits are not finite fails, judged once the window
    has closed: it counts as failed and adds neither images nor a
    latency."""
    def forward(self, x):
        y = self.model(x, mode="fixed", quant_w=self.quant_w, quant_a=True)
        return torch.full_like(y, float("nan"))

    result = tiny_run(CELLS[0], forward=forward)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] > 0
    assert "images_per_s" not in result["metrics"]
    assert "batch_ms_p95" not in result["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_tiny_run_is_correct(cell):
    assert tiny_run(cell)["correct"] is True


def test_exits_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", str(2 ** 40 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_exits_in_a_checkout_of_the_benchmark_alone(tmp_path):
    """Only BENCHMARK.json and the files under ``paths``: no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert not [l for l in out.stdout.splitlines() if l.startswith('{"correct"')]
