"""True multi-process calibration of the port: two processes joined by
``parallel.initialize`` (gloo, ``tcp://localhost``), each calibrating on
its half of the seeded 16-image batch, against JAX's single-process
calibration on the whole batch; the counterpart of tests/test_multihost.py
and tests/_multihost_prog.py.  Bounds as JAX's test holds its own: the
stem's maxval rtol 1e-6, conv1's activation xmax rtol 1e-5.  Also: the
``parallel`` package loads no JAX module."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from tests._tiny_torch import tiny_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP8 = dict(qmethod="fp_quantizer", per_channel_weights=True, fp8_set_maxval=True,
           weight_range_method="current_minmax", act_range_method="allminmax")
TIMEOUT = 120


def _x_full():
    return np.random.RandomState(0).normal(0, 1, (16, 16, 16, 3)).astype(np.float32)


def rank_main(pid: int, port: int, init_path: str) -> None:
    """One process: its half of the batch, calibrated with the estimators
    reducing over both processes; process 0 prints the result."""
    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.parallel import (
        collectives, initialize, local_rows, make_mesh)
    from fp8_quantization_tpu_torch.parallel.multihost import shutdown

    torch.set_num_threads(1)
    info = initialize(init_method=f"tcp://localhost:{port}", world_size=2,
                      rank=pid, device="cpu")
    assert info["global_devices"] == 2 and info["process_index"] == pid, info
    mesh = make_mesh(data=2, model=1)
    x_full = _x_full()
    x_local = local_rows(x_full, mesh)
    assert np.array_equal(x_local, x_full[pid * 8:(pid + 1) * 8])
    model = tiny_model(make_layer_config(**FP8))
    model.load_state_dict(torch.load(init_path, weights_only=True))
    with collectives.reducing_over(mesh.data_group):
        calibrate(model, [x_local], device="cpu")
    if pid == 0:
        print("RESULT " + json.dumps(
            {"stem_maxval": model.conv1.weight_q.maxval.tolist(),
             "act_xmax": float(model.conv1.act_q.est_xmax)}), flush=True)
    shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_calibration_matches_single_process(tmp_path):
    import jax
    import jax.numpy as jnp

    from fp8_quantization_tpu.calibration.calibrate import calibrate as j_calibrate
    from fp8_quantization_tpu.nn.config import make_layer_config as j_config
    from tests._tiny import TinyModel as JTiny

    x_full = jnp.asarray(_x_full())
    jmodel = JTiny(config=j_config(**FP8))
    jvars = jmodel.init(jax.random.PRNGKey(0), x_full[:8])
    model = tiny_model(make_layer_config(**FP8))
    convert.load_jax_variables(model, jax.tree.map(np.asarray, jvars))
    torch.save(model.state_dict(), tmp_path / "init.pt")

    port = _free_port()
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_multihost import rank_main; "
            "rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, ROOT, str(pid), str(port),
         str(tmp_path / "init.pt")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT) for pid in (0, 1)]
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
        assert p.returncode == 0, f"rc={p.returncode}\n{so}\n{se[-3000:]}"
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT ")][-1]
    dist = json.loads(line[len("RESULT "):])

    ref = j_calibrate(jmodel, jvars, [x_full])
    np.testing.assert_allclose(
        np.asarray(dist["stem_maxval"]),
        np.asarray(ref["quant"]["conv1"]["weight_q"]["q"]["maxval"]), rtol=1e-6)
    np.testing.assert_allclose(
        dist["act_xmax"],
        float(np.asarray(ref["quant"]["conv1"]["act_q"]["est"]["xmax"])),
        rtol=1e-5)


def test_parallel_imports_no_jax():
    """Importing fp8_quantization_tpu_torch.parallel loads no module of JAX
    or of the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, json; import fp8_quantization_tpu_torch.parallel; "
         "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] "
         "in ('jax', 'jaxlib', 'fp8_quantization_tpu'))))"],
        capture_output=True, text=True, cwd=ROOT, timeout=TIMEOUT, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
