"""Distribution of the port (fp8_quantization_tpu_torch/parallel/) over
torch.distributed's gloo backend on the CPU, against the JAX package: the
counterpart of tests/test_parallel.py.

One module-scoped spawn of 4 ranks (subprocesses, each wait under 120 s;
no process group ever starts in the pytest worker) runs every scenario on
the tiny model (tests/_tiny_torch.py, carried from JAX's tests/_tiny.py by
``load_jax_variables``) with the 16-image seeded batch of JAX's tests and
returns what each rank held:

* the mesh shapes of a 4-rank world, rank ``r`` at ``(r // model, r %
  model)``, and the ``ValueError`` of a mesh larger or smaller than it;
* ``shard_variables``' rule: conv1's weight and its per-channel ``maxval``
  sharded over the output channel, ``mantissa_bits`` replicated; the
  sharded-then-gathered state dict equal to the unsharded one;
* data-parallel (4 x 1) and dp+tp (2 x 2) calibration against the port's
  single process (bit-equal: min and max are order-free), JAX's
  single-device ``calibrate`` and JAX's ``calibrate_sharded`` on the same
  meshes over the 8 virtual CPU devices (rtol 1e-6 / atol 1e-7, JAX's
  own bound);
* data-parallel evaluation (top-1 / top-5 equal, loss rtol 1e-5);
* weight-gather tensor parallelism (1 x 4): logits bit-equal to the
  single-process forward, and within JAX's bound of JAX's;
* the MSE search and the line search, data-parallel, against the port's
  single process and JAX's single device: every table within rtol 1e-5
  of one process's and 5e-5 of JAX's (tests/test_torch_search.py's bound
  between the packages: the port's single-process tables already sit up
  to 1.9e-5 from JAX's on conv1's weight table, which no rank reduces),
  the voted mantissa bits equal and each pick equal wherever its two best
  candidates' errors differ by more than 1e-5; the percentile,
  data-parallel, bit-equal to one process (the gathered sample is the
  whole batch);
* one data-parallel QAT step (SGD with momentum and weight decay, Adam on
  the learned maxvals): the four ranks' parameters, BN statistics,
  quantizer state and both optimizers' state bit-equal to each other, and
  the step against the port's single-process step at the global batch and
  JAX's step at the bounds of tests/test_torch_qat.py (one step); the
  same data-parallel step with stochastic rounding against the port's
  single process (torch's generators cannot draw JAX's bits), and the
  ranks' rows of noise (``collectives.rand_rows``) against one draw at the
  global batch;
* the kernel gate under ``auto`` (races stubbed): rank 0 alone races and
  writes the cache file, and every rank holds rank 0's verdicts;
* a checkpoint saved by every rank: rank 0 writes, every rank restores;
* ``validate-quantized --data-parallel 2 --model-parallel 2`` through the
  CLI's entry point: rank 0 alone prints, the single process's line.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from fp8_quantization_tpu_torch.models import convert
from fp8_quantization_tpu_torch.nn.config import make_layer_config
from fp8_quantization_tpu_torch.nn.quantizers import Quantizer
from fp8_quantization_tpu_torch.parallel import collectives
from tests._tiny_torch import tiny_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT = 120

FP8 = dict(qmethod="fp_quantizer", per_channel_weights=True, fp8_set_maxval=True,
           weight_range_method="current_minmax", act_range_method="allminmax")
CASES = {
    "fp8": FP8,
    # tests/test_torch_search.py's tiny-model MSE settings
    "mse": dict(per_channel_weights=True, fp8_set_maxval=True,
                weight_range_method="MSE", act_range_method="MSE",
                num_candidates=31, act_num_candidates=21),
    "line": dict(per_channel_weights=True, fp8_set_maxval=True,
                 weight_range_method="line_search",
                 act_range_method="line_search", num_candidates=31,
                 act_num_candidates=21),
    "pct": dict(FP8, act_range_method="current_minmax", percentile=1.0),
    "qat": dict(FP8, fp8_learn_maxval=True),
}
# the QAT step with stochastic rounding (the calibrated state of "qat")
QAT_SR = dict(CASES["qat"], grad_estimator="stoch_round")
# QAT scenarios: (mesh, layer config)
QAT_RUNS = {"dp": ("dp", CASES["qat"]), "dptp": ("dptp", CASES["qat"]),
            "dp_sr": ("dp", QAT_SR)}
MESHES = {"dp": (4, 1), "dptp": (2, 2), "tp": (1, 4)}
CLI = ["validate-quantized", "--device", "cpu", "--engine", "fused",
       "--per-channel", "--fp8-set-maxval", "--num-est-batches", "1",
       "--max-eval-batches", "1", "--batch-size", "4"]


def _batch(n=16, size=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (n, size, size, 3)).astype(np.float32),
            rng.randint(0, classes, n).astype(np.int64))


def _quant_state(model) -> dict:
    """{(module path parts..., 'q' or 'est', name): value} of every
    quantizer, in JAX's quant-tree paths."""
    out = {}
    for name, qz in model.named_modules():
        if isinstance(qz, Quantizer):
            parts = tuple(name.split("."))
            for k, v in qz.state().items():
                out[parts + ("q", k)] = v.clone()
            for k, v in qz.est_state().items():
                out[parts + ("est", k)] = v.clone()
    return out


def _qat_state(model):
    """The QAT state of the scenarios: SGD with momentum and weight decay,
    Adam on the learned maxvals, oscillation dampening and freezing."""
    from fp8_quantization_tpu_torch.training import qat as tqat
    from fp8_quantization_tpu_torch.training.oscillation import OscillationConfig
    return tqat.init_qat_state(
        model, model.config,
        tqat.make_optimizer("SGD", 0.01, momentum=0.9, weight_decay=1e-4),
        tqat.make_optimizer("Adam", 1e-3),
        oscillation=OscillationConfig(dampen_weight=0.01, freeze_threshold=0.02,
                                      total_steps=10))


# ---- the ranks -------------------------------------------------------------------

def rank_main(rank: int, port: int, spec_path: str, out_dir: str) -> None:
    """One rank's scenarios; its results go to ``out_dir/rank<r>.pt``."""
    import contextlib
    import io

    from fp8_quantization_tpu_torch.calibration.calibrate import evaluate
    from fp8_quantization_tpu_torch.ops.kernels import autotune
    from fp8_quantization_tpu_torch.parallel import (
        calibrate_sharded, evaluate_sharded, gather_weights, initialize,
        make_mesh, shard_batch, shard_qat_state, shard_variables)
    from fp8_quantization_tpu_torch.parallel.api import state_bytes
    from fp8_quantization_tpu_torch.training import qat as tqat
    from fp8_quantization_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    info = initialize(f"tcp://localhost:{port}", world_size=WORLD, rank=rank,
                      device="cpu")
    x, y = spec["x"], spec["y"]
    res = {"info": info}

    def fresh(case, key="init", config=None):
        model = tiny_model(make_layer_config(**(config or CASES[case])))
        model.load_state_dict(spec[case][key])
        return model

    meshes = {k: make_mesh(*v) for k, v in MESHES.items()}
    res["mesh"] = {k: (m.shape, m.data_index, m.model_index)
                   for k, m in meshes.items()}
    res["mesh_inferred"] = make_mesh(model=2).shape
    res["mesh_errors"] = []
    for shape in ((3, 3), (1, 1), (2, 1)):
        try:
            make_mesh(*shape)
        except ValueError as e:
            res["mesh_errors"].append(str(e))

    model = fresh("fp8")
    shard_variables(meshes["dptp"], model)
    res["rule"] = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    with gather_weights(meshes["dptp"], model):
        res["rule_gathered"] = {k: v.clone() for k, v in model.state_dict().items()}

    for name in ("dp", "dptp"):
        model = fresh("fp8")
        stats = collectives.CollectiveStats()
        calibrate_sharded(model, [x], meshes[name], device="cpu",
                          tensor_parallel=name == "dptp", stats=stats)
        with gather_weights(meshes[name], model):
            res["cal_" + name] = _quant_state(model)
        res["collectives_" + name] = stats.count
        if name == "dp":
            res["eval_dp"] = evaluate_sharded(model, [(x, y)], meshes["dp"],
                                              device="cpu")

    model = fresh("fp8", "calibrated")
    full = state_bytes(model)
    shard_variables(meshes["tp"], model)
    res["tp_bytes"] = (full, state_bytes(model))
    with torch.no_grad():
        res["tp_logits"] = model(torch.from_numpy(x), mode="fixed")
    res["tp_eval"] = evaluate(model, [(x, y)], device="cpu")

    for case in ("mse", "line", "pct"):
        model = fresh(case)
        calibrate_sharded(model, [x], meshes["dp"], device="cpu")
        res["cal_" + case] = _quant_state(model)

    for name, (mesh_name, config) in QAT_RUNS.items():
        mesh = meshes[mesh_name]
        model = fresh("qat", "calibrated", config)
        state = shard_qat_state(mesh, _qat_state(model),
                                tensor_parallel=mesh_name == "dptp")
        step = tqat.make_train_step(state, mode="learn")
        _, metrics = step(state, shard_batch(mesh, x), shard_batch(mesh, y))
        opt = [o.state_dict() for o in (state.optimizer, state.quant_optimizer)]
        with gather_weights(mesh, model):
            res["qat_" + name] = {
                "metrics": metrics, "opt": opt,
                "momentum_shape": tuple(state.optimizer.state[
                    model.conv1.weight]["momentum_buffer"].shape),
                "state": {k: v.clone() for k, v in model.state_dict().items()},
                "osc": {k: {n: t.clone() for n, t in v.items()}
                        for k, v in state.osc_state.items()}}

    res["rand_rows"] = {}
    for name in ("dp", "dptp"):
        with collectives.reducing_over(meshes[name].data_group):
            res["rand_rows"][name] = collectives.rand_rows(
                (2, 3), torch.Generator().manual_seed(5))

    # the kernel gate: rank 0 races (stubbed) and writes; all take its verdicts
    races = []
    saved = (autotune.MODE, autotune._CACHE_PATH, autotune.on_card, autotune._race)

    def race(what, key, kernel, composed, device):
        races.append(key)
        return bool(key[0] % 2) ^ bool(rank)       # what a rank would decide
    try:
        autotune.MODE = "auto"
        autotune._CACHE.clear()
        autotune._CACHE_PATH = os.path.join(out_dir, f"gate_{rank}.json"
                                            if rank else "gate.json")
        autotune.on_card, autotune._race = (lambda like: True), race
        like = torch.zeros(1)
        gates = [autotune.pallas_wins(m, 8, 8, like=like, kernel=None, composed=None)
                 for m in (3, 4, 3, 5)]
        res["gate"] = {"answers": gates, "table": autotune.decision_table(),
                       "races": races}
    finally:
        (autotune.MODE, autotune._CACHE_PATH, autotune.on_card,
         autotune._race) = saved
        autotune._CACHE.clear()

    ck = os.path.join(out_dir, "ck")
    model = fresh("fp8", "calibrated")
    path = save_checkpoint(ck, model, step=3)
    res["ck_files"] = sorted(os.listdir(path))
    restored = restore_checkpoint(ck, fresh("fp8"))
    res["ck_equal"] = all(torch.equal(a, b) for a, b in zip(
        restored.state_dict().values(), model.state_dict().values()))
    # the CLI's entry point with both axes: only rank 0 prints its line (last: it
    # leaves the group)
    from fp8_quantization_tpu_torch.cli import image_net
    os.environ["WORLD_SIZE"] = str(WORLD)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        image_net.main(CLI + ["--data-parallel", "2", "--model-parallel", "2"])
    res["cli"] = out.getvalue()

    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


# ---- the JAX side and the spawn --------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, the port's single-process results, each rank's
    results)."""
    import jax
    import jax.numpy as jnp

    from fp8_quantization_tpu.calibration.calibrate import (
        calibrate as j_calibrate, evaluate as j_evaluate)
    from fp8_quantization_tpu.nn.config import make_layer_config as j_config
    from fp8_quantization_tpu.parallel import (
        calibrate_sharded as j_calibrate_sharded, make_mesh as j_make_mesh)
    from fp8_quantization_tpu_torch.calibration.calibrate import (
        calibrate, evaluate)
    from tests._tiny import TinyModel as JTiny, japply

    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("parallel")
    x, y = _batch()
    jx = jnp.asarray(x)
    spec, jres, single = {"x": x, "y": y}, {}, {}
    for case, cfg in CASES.items():
        jmodel = JTiny(config=j_config(**cfg))
        jvars = jmodel.init(jax.random.PRNGKey(0), jx)
        jcal = j_calibrate(jmodel, jvars, [jx])
        model = tiny_model(make_layer_config(**cfg))
        convert.load_jax_variables(model, _np_tree(jvars))
        init = {k: v.clone() for k, v in model.state_dict().items()}
        calibrate(model, [x], device="cpu")
        single[case] = _quant_state(model)
        spec[case] = {"init": init,
                      "calibrated": {k: v.clone() for k, v in model.state_dict().items()}}
        jres[case] = {"model": jmodel, "init": jvars, "cal": _np_tree(jcal)}
        if case == "fp8":
            jres["sharded"] = {
                name: _np_tree(j_calibrate_sharded(
                    jmodel, jvars, [jx], j_make_mesh(data=d, model=m),
                    tensor_parallel=m > 1))
                for name, (d, m) in (("dp", (4, 1)), ("dptp", (2, 2)))}
            jres["eval"] = j_evaluate(jmodel, jcal, [(jx, jnp.asarray(y))])
            jres["logits"] = np.asarray(japply(jmodel, jcal, jx, mode="fixed"))
            with torch.no_grad():
                single["logits"] = model(torch.from_numpy(x), mode="fixed")
            single["eval"] = evaluate(model, [(x, y)], device="cpu")
    torch.save(spec, tmp / "spec.pt")

    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_parallel import rank_main; "
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
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return jres, single, ranks, tmp


def _jax_leaf(tree, key):
    node = tree["quant"]
    for part in key:
        node = node[part]
    return np.asarray(node)


def _assert_close_to_jax(ours: dict, jtree, rtol=1e-6, atol=1e-7):
    for key, v in ours.items():
        ref = _jax_leaf(jtree, key)
        np.testing.assert_allclose(v.numpy().reshape(ref.shape), ref,
                                   rtol=rtol, atol=atol, err_msg=str(key))


def _assert_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---- the tests -------------------------------------------------------------------

def test_make_mesh_shapes(runs):
    _, _, ranks, _ = runs
    for r, res in enumerate(ranks):
        assert res["info"]["process_count"] == WORLD
        assert res["info"]["process_index"] == r
        for name, (d, m) in MESHES.items():
            shape, di, mi = res["mesh"][name]
            assert shape == {"data": d, "model": m}
            assert (di, mi) == (r // m, r % m)
        assert res["mesh_inferred"] == {"data": 2, "model": 2}
        assert len(res["mesh_errors"]) == 3
        assert "> 4 ranks" in res["mesh_errors"][0]


def test_shard_variables_tp_rules(runs):
    """conv1's kernel (8, 3, 3, 3) is sharded over its 8 output channels,
    its per-channel maxval (8,) the same way, mantissa_bits (a scalar)
    and the per-tensor activation state replicated; gathered, the state
    dict is the unsharded one."""
    _, _, ranks, tmp = runs
    init = torch.load(tmp / "spec.pt", weights_only=False)["fp8"]["init"]
    for res in ranks:
        rule = res["rule"]
        assert rule["conv1.weight"] == (4, 3, 3, 3)
        assert rule["conv1.weight_q.maxval"] == (4,)
        assert rule["conv1.running_mean"] == (4,)
        assert rule["fc.weight"] == (2, 16)
        assert rule["conv1.weight_q.mantissa_bits"] == ()
        assert rule["conv1.act_q.maxval"] == ()
        _assert_equal(res["rule_gathered"], init)


@pytest.mark.parametrize("name", ["dp", "dptp"], ids=["dp", "dp+tp"])
def test_sharded_calibration_matches_single_device(runs, name):
    jres, single, ranks, _ = runs
    for res in ranks:
        _assert_equal(res["cal_" + name], single["fp8"])
        _assert_close_to_jax(res["cal_" + name], jres["fp8"]["cal"])
        _assert_close_to_jax(res["cal_" + name], jres["sharded"][name])
        # one collective (min and max) per activation quantizer per batch
        assert res["collectives_" + name] == 3


def test_sharded_eval_matches_single_device(runs):
    jres, single, ranks, _ = runs
    for res in ranks:
        out = res["eval_dp"]
        assert out["num_examples"] == jres["eval"]["num_examples"] == 16
        for k in ("top_1_accuracy", "top_5_accuracy"):
            assert out[k] == single["eval"][k]
            np.testing.assert_allclose(out[k], jres["eval"][k])
        np.testing.assert_allclose(out["loss"], single["eval"]["loss"], rtol=1e-5)
        np.testing.assert_allclose(out["loss"], jres["eval"]["loss"], rtol=1e-5)


def test_weight_gather_tp_matches_single_device(runs):
    """Weight-gather tp (each rank holds a quarter of each sharded tensor
    at rest, gathered at the forward's entry) == the single forward."""
    jres, single, ranks, _ = runs
    for res in ranks:
        assert torch.equal(res["tp_logits"], single["logits"])
        np.testing.assert_allclose(res["tp_logits"].numpy(), jres["logits"],
                                   rtol=1e-6, atol=1e-6)
        assert res["tp_eval"] == single["eval"]
        full, at_rest = res["tp_bytes"]
        assert at_rest < full


def _check_table_picks(ours, ref, jref, rtol=1e-5, jax_rtol=5e-5):
    """Each ``est`` table of ``ours`` within ``rtol`` of ``ref`` (one
    process) and ``jax_rtol`` of ``jref`` (JAX: tests/test_torch_search.py's
    bound between the packages' tables, whose float32 sums run in other
    orders even on one process); the mantissa bits equal; each channel's
    maxval equal where its two best candidates differ by more than
    rtol."""
    for key, v in ours.items():
        if key[-2:] in (("est", "mses"), ("est", "losses")):
            np.testing.assert_allclose(v.numpy(), ref[key].numpy(), rtol=rtol,
                                       err_msg=str(key))
            jt = _jax_leaf(jref, key)
            np.testing.assert_allclose(v.numpy(), jt.reshape(v.shape),
                                       rtol=jax_rtol, err_msg=str(key))
        if key[-1] == "mantissa_bits":
            assert torch.equal(v, ref[key]), key
            assert float(v) == float(_jax_leaf(jref, key)), key
    for key, v in ours.items():
        if key[-2:] not in (("est", "mses"), ("est", "losses")):
            continue
        table = v.numpy()
        table = table.min(axis=0) if table.ndim == 3 else table    # best M
        pick = ("q", "maxval")
        mv = ours[key[:-2] + pick].numpy().reshape(-1)
        for c in range(table.shape[-1]):
            col = np.sort(table[:, c])
            if col[1] - col[0] > rtol * abs(col[1]):
                assert mv[c] == ref[key[:-2] + pick].numpy().reshape(-1)[c], key
                np.testing.assert_allclose(
                    mv[c], _jax_leaf(jref, key[:-2] + pick).reshape(-1)[c],
                    rtol=1e-6, err_msg=str(key))


@pytest.mark.parametrize("case", ["mse", "line"])
def test_search_dp_matches_jax_single_device(runs, case):
    """The MSE search (summed tables, then the vote) and the line search,
    data-parallel over 4 ranks, against one process and JAX's one
    device."""
    jres, single, ranks, _ = runs
    for res in ranks:
        _check_table_picks(res["cal_" + case], single[case], jres[case]["cal"])
    for res in ranks[1:]:
        _assert_equal(res["cal_" + case], ranks[0]["cal_" + case])


def test_percentile_dp_equals_one_process(runs):
    """--percentile gathers the whole sample before its sort: bit-equal to
    one process, and to JAX within its bound."""
    jres, single, ranks, _ = runs
    for res in ranks:
        _assert_equal(res["cal_pct"], single["pct"])
        _assert_close_to_jax(res["cal_pct"], jres["pct"]["cal"], rtol=1e-5,
                             atol=1e-6)


@pytest.fixture(scope="module")
def qat_single(runs):
    """The port's single-process QAT step and JAX's, at the global batch,
    from the state the ranks started from."""
    import jax
    import jax.numpy as jnp

    from fp8_quantization_tpu import training as jtr
    from fp8_quantization_tpu.nn.config import make_layer_config as j_config
    from fp8_quantization_tpu_torch.training import qat as tqat
    jres, _, _, tmp = runs
    spec = torch.load(tmp / "spec.pt", weights_only=False)
    x, y = spec["x"], spec["y"]
    before = spec["qat"]["calibrated"]
    ports = {}
    for config in (CASES["qat"], QAT_SR):
        model = tiny_model(make_layer_config(**config))
        model.load_state_dict(before)
        state = _qat_state(model)
        _, metrics = tqat.make_train_step(state, mode="learn")(state, x, y)
        ports[config["grad_estimator"] if "grad_estimator" in config
              else "ste"] = (model, metrics, state)

    from fp8_quantization_tpu.training.oscillation import (
        OscillationConfig as JOscillationConfig)
    jmodel, jcal = jres["qat"]["model"], jres["qat"]["cal"]
    jstate, aux = jtr.init_qat_state(
        jax.tree.map(jnp.asarray, jcal), j_config(**CASES["qat"]),
        jtr.make_optimizer("SGD", 0.01, momentum=0.9, weight_decay=1e-4),
        jtr.make_optimizer("Adam", 1e-3), model=jmodel,
        oscillation=JOscillationConfig(dampen_weight=0.01, freeze_threshold=0.02,
                                       total_steps=10))
    jstep = jtr.make_train_step(jmodel, aux, mode="learn", donate=False)
    jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y.astype(np.int32)))
    jmodel_port = tiny_model(make_layer_config(**CASES["qat"]))
    convert.load_jax_variables(jmodel_port, _np_tree(jstate.variables()))
    return before, ports, jmodel_port, float(jm["loss"])


@pytest.mark.parametrize("name", ["dp", "dptp", "dp_sr"],
                         ids=["dp", "dp+tp", "dp-stoch_round"])
def test_qat_step_matches_one_process(runs, qat_single, name):
    """One QAT step (SGD, Adam on the learned maxvals, dampening and
    freezing), data-parallel (4 x 1) and dp+tp (2 x 2): the ranks' whole
    state (gathered under tp) bit-equal after the step, BN's running
    statistics and the oscillation state included, and each model index's
    optimizer state; under tp each rank's momentum holds its slice alone;
    the step against one process at the global batch and against JAX at
    tests/test_torch_qat.py's one-step bounds.  With stochastic rounding
    (4 x 1) the step is held against one process alone, whose noise the
    ranks' rows share."""
    from tests.test_torch_qat import _compare, _updates
    _, _, ranks, _ = runs
    before, ports, jmodel_port, jloss = qat_single
    mesh_name, config = QAT_RUNS[name]
    model, metrics, state = ports[config.get("grad_estimator", "ste")]
    key = "qat_" + name
    ref = ranks[0][key]
    model_size = MESHES[mesh_name][1]
    for r, res in enumerate(ranks):
        _assert_equal(res[key]["state"], ref["state"])
        for layer, osc in res[key]["osc"].items():
            _assert_equal(osc, ref["osc"][layer])
        assert res[key]["metrics"] == ref["metrics"]
        assert res[key]["momentum_shape"] == (8 // model_size, 3, 3, 3)
        peer = ranks[r % model_size][key]
        for a, b in zip(res[key]["opt"], peer["opt"]):
            for p in a["state"]:
                for k, v in a["state"][p].items():
                    assert torch.equal(torch.as_tensor(v),
                                       torch.as_tensor(b["state"][p][k])), (p, k)
    np.testing.assert_allclose(ref["metrics"]["loss"], metrics["loss"], rtol=1e-5)
    for layer, osc in ref["osc"].items():
        for n, t in osc.items():
            torch.testing.assert_close(t, state.osc_state[layer][n],
                                       rtol=1e-5, atol=1e-6)
    moved = _updates(_with_state(ref["state"]), before)
    _compare(moved, _updates(model, before), tight=True)
    if config is CASES["qat"]:
        np.testing.assert_allclose(ref["metrics"]["loss"], jloss, rtol=1e-4)
        _compare(moved, _updates(jmodel_port, before), tight=True)
    running = [k for k in ref["state"] if "running" in k]
    assert running and all(not torch.equal(ref["state"][k], before[k])
                           for k in running)


class _with_state:
    """A stand-in with ``state_dict()`` for tests/test_torch_qat._updates."""

    def __init__(self, state):
        self._state = state

    def state_dict(self):
        return self._state


def test_cli_dp_tp_matches_one_process(runs, capsys):
    """validate-quantized --data-parallel 2 --model-parallel 2 (ResNet-18
    on the fused engine's plain versions): rank 0 alone prints, and its
    line is the single process's (top-1 and top-5 equal, loss rtol 1e-5,
    the same examples)."""
    import json

    from fp8_quantization_tpu_torch.cli import image_net
    _, _, ranks, _ = runs
    assert [bool(r["cli"].strip()) for r in ranks] == [True, False, False, False]
    ours = json.loads(ranks[0]["cli"].strip().splitlines()[-1])
    image_net.main(CLI)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours["num_examples"] == ref["num_examples"] == 4
    assert ours["top_1_accuracy"] == ref["top_1_accuracy"]
    assert ours["top_5_accuracy"] == ref["top_5_accuracy"]
    np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-5)


def test_rand_rows_are_the_ranks_rows_of_one_draw(runs):
    """Under a scope each rank draws its rows of the noise one process
    draws for the global batch (4 x 1 and the data axis of 2 x 2)."""
    _, _, ranks, _ = runs
    for name, (data, model_size) in (("dp", MESHES["dp"]), ("dptp", MESHES["dptp"])):
        full = torch.rand((2 * data, 3), generator=torch.Generator().manual_seed(5))
        for r, res in enumerate(ranks):
            i = r // model_size
            assert torch.equal(res["rand_rows"][name], full[2 * i:2 * i + 2]), (name, r)


def test_gate_takes_rank0_verdicts(runs):
    """Under 'auto' rank 0 alone races (once per key) and writes the cache
    file; every rank answers with rank 0's verdicts."""
    _, _, ranks, tmp = runs
    assert ranks[0]["gate"]["races"] == [(3, 8, 8), (4, 8, 8), (5, 8, 8)]
    for res in ranks:
        assert res["gate"]["answers"] == [True, False, True, True]
        assert res["gate"]["table"] == ranks[0]["gate"]["table"]
    for res in ranks[1:]:
        assert res["gate"]["races"] == []
    assert (tmp / "gate.json").exists()
    assert not any((tmp / f"gate_{r}.json").exists() for r in range(1, WORLD))


def test_checkpoint_rank0_writes_every_rank_restores(runs):
    _, _, ranks, _ = runs
    for res in ranks:
        assert res["ck_files"] == ["state.pt"]
        assert res["ck_equal"]


def test_collectives_are_identities_outside_a_scope():
    t = torch.arange(6.0).reshape(2, 3)
    for fn in (collectives.all_sum, collectives.all_sum_grad,
               collectives.all_gather):
        assert fn(t) is t
    lo, hi = collectives.all_minmax(t[0], t[1])
    assert lo is t[0] or torch.equal(lo, t[0])
    assert not collectives.active() and collectives.size() == 1
    with collectives.reducing_over(None):
        assert not collectives.active()
    p = torch.nn.Parameter(torch.ones(2))
    collectives.average_gradients([p])
    assert p.grad is None


def test_cli_parallel_usage_errors(monkeypatch, capsys):
    from fp8_quantization_tpu_torch.cli import image_net
    base = ["validate-quantized", "--device", "cpu", "--batch-size", "6"]
    args = image_net.build_parser().parse_args(base)
    assert image_net.setup_parallel(args, "validate-quantized") is None
    for argv, env, msg in (
            (base + ["--data-parallel", "2"], "1", "!= 1 ranks"),
            (base + ["--data-parallel", "4"], "4", "does not split"),
            (base + ["--model-parallel", "0"], "1", "must be >= 1")):
        monkeypatch.setenv("WORLD_SIZE", env)
        args = image_net.build_parser().parse_args(argv)
        with pytest.raises(SystemExit) as e:
            image_net.setup_parallel(args, argv[0])
        assert e.value.code == 2
        assert msg in capsys.readouterr().err
