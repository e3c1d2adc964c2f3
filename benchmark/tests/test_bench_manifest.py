"""BENCHMARK.json and the files it names: keys, names and units, limits of
the contract, every cell's files found, every metric's reader found."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness, peaks

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# a width may never be cut (the contract's list, by key)
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|"
                   r"head|expansion|experts_per|widths?$|dim$|mlp_ratio|patch)")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert list(MANIFEST) == ["command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.rstrip("/").endswith("_torch")
    named = [w for w in cmd if "/" in w]
    assert all(any(w.startswith(p + "/") for p in paths) for w in named)


def test_run_seconds_fits_the_full_check():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    assert (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    for e in MANIFEST[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES


def test_configs():
    assert 1 <= len(MANIFEST["configs"]) <= 24
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert Path(c["file"]).stem == c["name"]
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] and body["source"] == c["source"]
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))


def test_workloads():
    w = MANIFEST["workloads"]
    assert 1 <= len(w) <= 24
    pairs = [(e["config"], e["traffic"]) for e in w]
    assert len(pairs) == len(set(pairs))
    four = sum(e["chips"] == 4 for e in w)
    assert four <= max(1, len(w) // 4)
    for e in w:
        assert set(e) == {"name", "config", "traffic", "chips", "why"}
        assert e["chips"] in (1, 4) and _line(e["why"])
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])


def test_metrics():
    e2e = MANIFEST["end_to_end"]
    assert 1 <= len(e2e) <= 16 and any(m["name"] == "setup_s" for m in e2e)
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    pl = MANIFEST["per_layer"]
    assert 1 <= len(pl) <= 128
    e2e_names = {m["name"] for m in e2e}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in pl:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e_names and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:      # every cell: setup_s, another end-to-end metric, a per-layer one
        mine = [m for m in e2e if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in pl)


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_found(cell):
    c = harness.Cell(cell, MANIFEST)
    bench = ROOT / "benchmark"
    assert (bench / "reference" / f"{c.config['architecture']}.py").is_file()
    assert (bench / "arch" / f"{c.config['architecture']}.py").is_file()
    assert c.traffic["batch"] >= 1 and c.traffic["pool"] >= 2
    assert c.config["datapath"] in peaks.OPS_PER_S and c.config["calibration_images"] >= 1
    assert c.spec["limits"]
    for kind in ("end_to_end", "per_layer"):
        for m in c.metrics[kind]:
            assert (bench / "metrics" / f"{m['name']}.py").is_file(), m["name"]
            assert callable(harness.load_module(bench / "metrics" / f"{m['name']}.py").read)


def test_paths_hold_only_names_of_names():
    for p in (ROOT / "benchmark").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert PATH.match(str(p.relative_to(ROOT))), p


def test_work_functions():
    work = harness.work_functions()
    assert {"qmatmul", "qconv3x3", "qstem", "flash_mha"} <= set(work)
    for mod in work.values():
        assert len(mod.WRAPPER) == 2 and mod.KERNELS and callable(mod.work)
