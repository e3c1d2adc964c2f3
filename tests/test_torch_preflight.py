"""``preflight`` and the dress rehearsal of the port (cli/image_net.py,
tools/dress_rehearsal.py) against the JAX package's, on the CPU.

* JAX's two scan tests (tests/test_preflight.py) against the port's
  ``_scan_real_assets``, and both packages' scans equal on one tree.
* ``preflight --scan-only --report-out``: the report's five keys, its
  command running the port's rehearsal, a detected checkpoint passed by
  its short name.
* The rehearsal's three state dicts have the keys, shapes and dtypes of
  JAX ``make_checkpoints``' (full width, 1000 classes).
* One rehearsal end to end on the CPU (ResNet-18, 8 JPEGs, batch 4): PIL is
  here, so the JPEG leg runs.
* Without PIL and without ``--images-dir`` the rehearsal stops with a
  message naming both.
* The short names of the scan map to the CLI's architectures in the port;
  JAX's rehearsal keys its flags by the CLI's names alone and raises
  ``KeyError`` for a short name.
"""

import json
import subprocess
import sys

import pytest
import torch

from fp8_quantization_tpu_torch.cli import image_net
from fp8_quantization_tpu_torch.tools import dress_rehearsal

REPORT_KEYS = {"scan", "resolved_images_dir", "resolved_model_dirs", "mode",
               "command"}


def _assets(tmp_path, monkeypatch):
    data = tmp_path / "imagenet"
    for i in range(60):
        (data / "val" / f"n{i:08d}").mkdir(parents=True)
    ck = tmp_path / "ckpts"
    ck.mkdir()
    (ck / "resnet18-f37072fd.pth").write_bytes(b"x")
    (ck / "mobilenet_v2.pth.tar").write_bytes(b"x")
    monkeypatch.setenv("IMAGENET_DIR", str(tmp_path))
    monkeypatch.setenv("MODEL_DIR", str(ck))
    return data


def test_scan_detects_mounted_tree(tmp_path, monkeypatch):
    data = _assets(tmp_path, monkeypatch)
    scan = image_net._scan_real_assets()
    assert scan["imagenet_root"] == str(data)
    assert scan["checkpoints"]["resnet18"].endswith("resnet18-f37072fd.pth")
    assert scan["checkpoints"]["mobilenet_v2"].endswith("mobilenet_v2.pth.tar")


def test_scan_empty_env(tmp_path, monkeypatch):
    monkeypatch.setenv("IMAGENET_DIR", str(tmp_path / "nope"))
    monkeypatch.setenv("MODEL_DIR", str(tmp_path / "nope2"))
    scan = image_net._scan_real_assets()
    assert isinstance(scan["checkpoints"], dict)


@pytest.mark.parametrize("assets", [True, False], ids=["assets", "empty"])
def test_scan_equals_jax(tmp_path, monkeypatch, assets):
    from cli.image_net import _scan_real_assets as j_scan
    if assets:
        _assets(tmp_path, monkeypatch)
    else:
        monkeypatch.setenv("IMAGENET_DIR", str(tmp_path / "nope"))
        monkeypatch.setenv("MODEL_DIR", str(tmp_path / "nope2"))
    assert image_net._scan_real_assets() == j_scan()


@pytest.mark.parametrize("assets", [True, False], ids=["assets", "empty"])
def test_scan_only_report(tmp_path, monkeypatch, capsys, assets):
    if assets:
        _assets(tmp_path, monkeypatch)
    else:
        monkeypatch.setenv("IMAGENET_DIR", str(tmp_path / "nope"))
        monkeypatch.setenv("MODEL_DIR", str(tmp_path / "nope2"))
    out = tmp_path / "report.json"
    image_net.main(["preflight", "--scan-only", "--report-out", str(out),
                    "--device", "cpu"])
    report = json.loads(out.read_text())
    assert set(report) == REPORT_KEYS
    assert json.loads(capsys.readouterr().out) == report
    assert "-m fp8_quantization_tpu_torch.tools.dress_rehearsal" in report["command"]
    assert "--device cpu" in report["command"]
    if assets:
        assert report["mode"] == "REAL assets"
        assert report["resolved_images_dir"] == str(tmp_path / "imagenet")
        assert "resnet18=" in report["resolved_model_dirs"]


def test_checkpoints_have_jax_keys_and_shapes(tmp_path):
    from tools.dress_rehearsal import make_checkpoints as j_make_checkpoints
    archs = ["resnet18", "mobilenet_v2", "vit_small"]
    (tmp_path / "jax").mkdir()
    ref = j_make_checkpoints(tmp_path / "jax", archs)
    ours = dress_rehearsal.make_checkpoints(tmp_path, archs)
    assert set(ours) == set(ref) == {"resnet18_quantized", "mobilenet_v2_quantized",
                                     "vit_small_quantized"}
    for arch, path in ours.items():
        a = torch.load(path, weights_only=True)
        b = torch.load(ref[arch], weights_only=True)
        assert a.keys() == b.keys(), arch
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (arch, k)


def test_rehearsal_end_to_end_on_cpu(tmp_path):
    results = dress_rehearsal.main(
        ["--workdir", str(tmp_path), "--archs", "resnet18", "--images", "8",
         "--batch-size", "4", "--max-eval-batches", "1", "--device", "cpu"])
    assert list(results) == ["resnet18_quantized"]
    m = results["resnet18_quantized"]
    assert m["num_examples"] == 4 and m["loss"] == m["loss"]
    assert len(list((tmp_path / "imagenet" / "val").rglob("*.jpg"))) == 8


def test_missing_pil_names_pil_and_images_dir(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(SystemExit) as e:
        dress_rehearsal.main(["--workdir", str(tmp_path), "--archs", "resnet18"])
    assert "PIL" in str(e.value.code) and "--images-dir" in str(e.value.code)
    assert not list(tmp_path.iterdir())         # nothing written, nothing run


def test_short_names_map_to_the_cli_architectures(tmp_path, monkeypatch):
    from tools.dress_rehearsal import BASELINE_FLAGS as J_FLAGS
    for short in ("resnet18", "mobilenet_v2", "vit_small", "resnet50"):
        arch = dress_rehearsal.architecture(short)
        assert arch == short + "_quantized"
        assert dress_rehearsal.architecture(arch) == arch
        assert dress_rehearsal.BASELINE_FLAGS[arch]
    with pytest.raises(KeyError):
        J_FLAGS["resnet18"]                     # what preflight passes JAX's
    with pytest.raises(ValueError):
        dress_rehearsal.architecture("resnet34")

    cmds = []

    def run(cmd, **kw):
        cmds.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, '{"top_1_accuracy": 0.0}\n', "")
    monkeypatch.setattr(dress_rehearsal.subprocess, "run", run)
    real = tmp_path / "resnet18-f37072fd.pth"
    dress_rehearsal.main(["--workdir", str(tmp_path), "--archs", "resnet18",
                          "--images-dir", str(tmp_path), "--model-dirs",
                          f"resnet18={real}", "--device", "cpu"])
    (cmd,) = cmds
    assert cmd[cmd.index("--architecture") + 1] == "resnet18_quantized"
    assert cmd[cmd.index("--model-dir") + 1] == str(real)
    assert cmd[-2:] == ["--device", "cpu"]
