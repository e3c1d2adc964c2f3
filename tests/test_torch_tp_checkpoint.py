"""Checkpoints of a tensor-parallel QAT state (utils/checkpoint.py with
parallel/api.py) over torch.distributed's gloo backend on the CPU.

One module-scoped spawn of two ranks (subprocesses, each wait under 120 s;
no process group ever starts in the pytest worker), mesh 1 x 2, on the
tiny model of tests/_tiny_torch.py (every layer's output channels split
over the two ranks) with tests/test_torch_checkpoint.py's QAT state: SGD
with momentum and weight decay, Adam on the learned maxvals, oscillation
freezing.  The ranks train two steps and save, train a third; then

* the tensor-parallel save has the keys, shapes and dtypes of the
  single-process save of the same two steps (the model's state dict, both
  optimizers' state, ``step``, ``osc_state``), while each rank's momentum
  holds its slice alone, and its values equal the single-process save's
  (the forward and backward run on the gathered weights, and the
  optimizers are elementwise);
* a single-process state restores it and takes the third step to the
  single-process run's state;
* two fresh ranks restore it, or the single-process save, and take the
  third step to the state of the ranks that were not interrupted, bit
  for bit;
* ``train-quantized --device cpu --model-parallel 2 --save-checkpoint-dir``
  (MobileNetV2, one step) writes ``step_0``, which restores into a
  single-process state.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from tests.test_torch_checkpoint import _qat_state, _train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT = 120
CLI = ["train-quantized", "--device", "cpu", "--architecture",
       "mobilenet_v2_quantized", "--engine", "fused", "--per-channel",
       "--fp8-set-maxval", "--fp8-learn-maxval", "--sep-quant-optimizer",
       "--num-est-batches", "1", "--max-train-batches", "1",
       "--max-eval-batches", "1", "--batch-size", "2",
       "--no-reestimate-bn-stats", "--model-parallel", "2"]


def _fresh(calibrated):
    state = _qat_state()
    state.model.load_state_dict(calibrated)
    return state


def _file(ck, step):
    return torch.load(os.path.join(ck, f"step_{step}", "state.pt"),
                      weights_only=True)


def rank_main(rank: int, port: int, spec_path: str, out_dir: str) -> None:
    """One rank's scenarios; what it holds goes to ``out_dir/rank<r>.pt``."""
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.parallel import (
        initialize, make_mesh, shard_qat_state)
    from fp8_quantization_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    initialize(f"tcp://localhost:{port}", world_size=WORLD, rank=rank,
               device="cpu")
    mesh = make_mesh(1, WORLD)

    def sharded():
        return shard_qat_state(mesh, _fresh(spec["calibrated"]),
                               tensor_parallel=True)

    res = {}
    state = _train(sharded(), 2)
    save_checkpoint(os.path.join(out_dir, "ck_tp"), state, step=2)
    res["momentum_shape"] = tuple(state.optimizer.state[
        state.model.conv1.weight]["momentum_buffer"].shape)
    save_checkpoint(os.path.join(out_dir, "ck_tp3"), _train(state, 1, start=2),
                    step=3)
    for name, ck in (("tp", "ck_tp"), ("single", "ck_single")):
        state = restore_checkpoint(os.path.join(out_dir, ck), sharded())
        res["restored_step_" + name] = state.step
        save_checkpoint(os.path.join(out_dir, f"resumed_{name}"),
                        _train(state, 1, start=2), step=3)

    os.environ["WORLD_SIZE"] = str(WORLD)
    image_net.main(CLI + ["--save-checkpoint-dir", os.path.join(out_dir, "ck_cli")])
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the directory of every save, each rank's results)."""
    from fp8_quantization_tpu_torch.utils.checkpoint import save_checkpoint

    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("tp_checkpoint")
    state = _qat_state()
    calibrated = {k: v.clone() for k, v in state.model.state_dict().items()}
    state = _train(state, 2)
    save_checkpoint(str(tmp / "ck_single"), state, step=2)
    save_checkpoint(str(tmp / "ck_single3"), _train(state, 1, start=2), step=3)
    torch.save({"calibrated": calibrated}, tmp / "spec.pt")

    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_tp_checkpoint import rank_main; "
            "rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, ROOT, str(r), str(port), str(tmp / "spec.pt"),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{so[-2000:]}\n{se[-4000:]}"
    return tmp, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(WORLD)], outs


def _assert_same(a, b, path="", shapes_only=False):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}", shapes_only)
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{path}[{i}]", shapes_only)
    elif isinstance(a, torch.Tensor):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert shapes_only or torch.equal(a, b), path
    else:
        assert a == b, path


def test_tp_save_has_the_unsharded_format(runs):
    tmp, ranks, _ = runs
    tp, single = _file(tmp / "ck_tp", 2), _file(tmp / "ck_single", 2)
    _assert_same(tp, single, shapes_only=True)
    assert tp["step"] == 2 and tp["optimizer"]["state"]
    assert tp["model"]["conv1.weight"].shape == (8, 3, 3, 3)
    assert tp["optimizer"]["state"][0]["momentum_buffer"].shape == (8, 3, 3, 3)
    for res in ranks:
        assert res["momentum_shape"] == (4, 3, 3, 3)
    _assert_same(tp, single)


def test_single_process_restores_a_tp_save(runs, tmp_path):
    from fp8_quantization_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)
    tmp, _, _ = runs
    calibrated = torch.load(tmp / "spec.pt", weights_only=False)["calibrated"]
    state = restore_checkpoint(str(tmp / "ck_tp"), _fresh(calibrated))
    assert state.step == 2
    save_checkpoint(str(tmp_path / "ck"), _train(state, 1, start=2), step=3)
    _assert_same(_file(tmp_path / "ck", 3), _file(tmp / "ck_single3", 3))


@pytest.mark.parametrize("source", ["tp", "single"])
def test_tp_ranks_restore_and_resume(runs, source):
    tmp, ranks, _ = runs
    assert all(res["restored_step_" + source] == 2 for res in ranks)
    _assert_same(_file(tmp / f"resumed_{source}", 3), _file(tmp / "ck_tp3", 3))


def test_cli_model_parallel_saves_step_0(runs):
    from fp8_quantization_tpu_torch.cli import image_net
    from fp8_quantization_tpu_torch.training import qat as tqat
    from fp8_quantization_tpu_torch.utils.checkpoint import restore_checkpoint
    tmp, _, outs = runs
    assert os.listdir(tmp / "ck_cli") == ["step_0"]
    assert [bool(so.strip()) for so, _ in outs] == [True, False]
    args = image_net.build_parser().parse_args(CLI[:-2])
    model = image_net.build_model(args)
    state = tqat.init_qat_state(model, model.config,
                                tqat.make_optimizer("SGD", 1e-3),
                                tqat.make_optimizer("Adam", 1e-5))
    state = restore_checkpoint(str(tmp / "ck_cli"), state)
    assert state.step == 1 and state.quant_optimizer.state_dict()["state"]
