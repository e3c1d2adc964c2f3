"""One run of one cell: set-up, the timed window, the optional profile, and
the comparison with the plain reference.

Everything a cell uses is found by name: ``BENCHMARK.json`` at the root of
the checkout lists the cells and the metrics; ``benchmark/cells/<cell>.json``
names the cell's configuration and traffic mix and holds its check's limits;
``benchmark/configs/<config>.json`` the model, the options as the port's
``validate-quantized`` takes them and the datapath; ``benchmark/traffic/
<mix>.json`` the batches; ``benchmark/arch/<architecture>.py`` the weights'
draw and the operations of a forward; ``benchmark/reference/<architecture>.py``
the plain reference; ``benchmark/work/<kernel>.py`` a kernel's work;
``benchmark/metrics/<metric>.py`` the reader of one metric.

Set-up, in order: the port's import; its kernels from ``build/kernels/``
(built by nvcc in a checkout's first run only); the weights, drawn on the
device from the seed in the published key layout and loaded through the
port's loader; calibration on ``--num-est-batches`` batches; the bake and
the prepare pass of ``validate-quantized``'s deploy path; the kernel gate
in its default mode ``auto``, its verdicts kept in a file inside the
checkout (``build/benchmark/``) so that only a checkout's first run races
them; a warm-up of the cell's own batch; the pool of input batches.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# the modules that may not be loaded in a run, by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "fp8_quantization_tpu")
WARM_BATCHES = 2
PROFILE_BATCHES = 3         # batches profiled after the window (--trace 1)
CHECK_BATCHES = 4           # the window's batches the check compares
HOST_ISSUE_S = 0.3          # host issue timing: at least this long in all
HOST_ISSUES = 5             # and at least this many forwards


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark._by_path." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def work_functions() -> dict:
    """{kernel: module} of every ``benchmark/work/<kernel>.py``."""
    return {p.stem: load_module(p) for p in sorted((BENCH / "work").glob("*.py"))}


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is a forbidden one."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


class Cell:
    """A cell as its files describe it."""

    def __init__(self, name: str, manifest: dict):
        entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, entry
        self.spec = load_json(BENCH / "cells" / f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if self.spec[key] != entry[key]:
                raise ValueError(f"cell {name}: {key} {self.spec[key]!r} in its "
                                 f"file, {entry[key]!r} in BENCHMARK.json")
        self.config = load_json(BENCH / "configs" / f"{entry['config']}.json")
        self.traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
        self.arch = importlib.import_module(
            f"benchmark.arch.{self.config['architecture']}")
        self.metrics = {
            kind: [m for m in manifest[kind]
                   if name in m.get("workloads", [name])]
            for kind in ("end_to_end", "per_layer")}


def cache_environment(cell: str) -> None:
    """The kernel gate's mode and verdict file (a fixed path inside the
    checkout, so that a checkout's later runs take the first's verdicts);
    set before the port is imported, which reads them."""
    cache = ROOT / "build" / "benchmark"
    cache.mkdir(parents=True, exist_ok=True)
    os.environ["FP8TPU_PALLAS_AUTOTUNE"] = "auto"
    os.environ["FP8TPU_AUTOTUNE_CACHE"] = str(cache / f"autotune-{cell}.json")


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _host_state_dict(sd: dict) -> dict:
    """``sd`` as numpy arrays on the host, copied in one transfer."""
    import torch
    flat = torch.cat([v.reshape(-1) for v in sd.values()]).cpu().numpy()
    out, at = {}, 0
    for k, v in sd.items():
        out[k] = flat[at:at + v.numel()].reshape(tuple(v.shape))
        at += v.numel()
    return out


class Run:
    """One run of a cell: ``setup``, ``window``, ``profile``, ``check``."""

    def __init__(self, cell: Cell, seed: int, seconds: float,
                 device: str = "cuda", t_start: float | None = None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device = device
        self.t_start = time.monotonic() if t_start is None else t_start
        self.config, self.traffic = cell.config, cell.traffic
        self.batch = self.traffic["batch"]
        self.profile_batches, self.check_batches = PROFILE_BATCHES, CHECK_BATCHES
        self.work = work_functions()
        self.times: dict = {}
        self.trace = None
        self.capture = None
        self.host_issue_s: list = []

    # ---- set-up ------------------------------------------------------------

    def setup(self) -> None:
        import torch

        from benchmark import traffic
        from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
        from fp8_quantization_tpu_torch.cli import image_net
        from fp8_quantization_tpu_torch.ops.kernels import autotune, build

        dev = self.device
        stages = self.times["stages"] = {}
        mark = [self.t_start]         # "import": the process start to here

        def stage(name):
            _sync(dev)
            now = time.monotonic()
            stages[name] = now - mark[0]
            mark[0] = now

        stage("import")
        if torch.device(dev).type == "cuda":
            self.times["build_s"] = build.build_all()
            torch.zeros(1, device=dev)
        stage("kernels")
        self.autotune = autotune
        args = self.args = image_net.build_parser().parse_args(
            ["validate-quantized", *self.config["options"], "--device", dev,
             "--batch-size", str(self.batch), "--seed", str(self.seed)])
        with torch.no_grad():
            self.sd = self.cell.arch.draw(self.config["model"],
                                          traffic.generator(self.seed, "weights", dev),
                                          dev)
        stage("weights")
        self.model = self._build(image_net, args, _host_state_dict(self.sd))
        stage("model")
        g = traffic.generator(self.seed, "calibration", dev)
        self.cal = [traffic.images(self.traffic["images"],
                                   self.config["calibration_images"], g, dev)
                    for _ in range(args.num_est_batches)]
        self.pool = traffic.pool(self.traffic, self.seed, dev)
        stage("inputs")
        calibrate(self.model, self.cal, device=dev, num_batches=args.num_est_batches,
                  quant_w=args.weight_quant, quant_a=args.act_quant)
        stage("calibrate")
        self.quant_w = image_net.bake_for_eval(self.model, args.weight_quant,
                                               args.bake_weights)
        image_net.prepare_for_eval(self.model, self.cal, dev, self.quant_w,
                                   args.act_quant)
        stage("bake_prepare")
        with torch.no_grad():
            self.forward(self.pool[0])
        stage("first_forward")
        with torch.no_grad():
            for i in range(WARM_BATCHES):
                self.forward(self.pool[1 + i % (len(self.pool) - 1)]).cpu()
        stage("warm_up")
        self.times.update(
            calibrate_s=stages["calibrate"],
            deploy_s=stages["bake_prepare"] + stages["first_forward"],
            setup_s=time.monotonic() - self.t_start)

    def _build(self, image_net, args, host_sd):
        """The model as ``validate-quantized`` builds it, with the drawn
        weights in place of the port's own random draw."""
        from fp8_quantization_tpu_torch.models import convert
        saved = getattr(convert, self.cell.arch.PORT_DRAW)
        setattr(convert, self.cell.arch.PORT_DRAW, lambda *a, **k: host_sd)
        try:
            return image_net.build_model(args)
        finally:
            setattr(convert, self.cell.arch.PORT_DRAW, saved)

    def verdicts(self) -> dict:
        """The gate's verdicts and the races this process ran."""
        at = self.autotune
        return {"gate_mode": at.MODE, "verdicts": at.decision_table(),
                "races": {at.key_name(k): list(v) for k, v in at.races().items()}}

    # ---- the timed path -----------------------------------------------------

    def forward(self, x):
        """The deployed forward: fixed mode on the baked, prepared model."""
        return self.model(x, mode="fixed", quant_w=self.quant_w, quant_a=True)

    def window(self) -> None:
        """A closed loop with one client for ``seconds``: batches back to
        back from the pool, each done when its logits are on the host; a
        batch that raises or gives logits that are not finite fails.  The
        logits are judged finite once the window has closed, so that the
        harness's own test takes no host time between batches."""
        import torch
        done, failed, i = [], 0, 0
        n_pool = len(self.pool)
        _sync(self.device)
        t0 = time.perf_counter()
        end = t0 + self.seconds
        with torch.no_grad():
            while time.perf_counter() < end:
                x = self.pool[i % n_pool]
                ts = time.perf_counter()
                try:
                    y = self.forward(x).cpu()
                except RuntimeError as err:
                    print(f"batch {i} failed: {err}", file=sys.stderr)
                    failed, i = failed + 1, i + 1
                    continue
                done.append((i, y, time.perf_counter() - ts))
                i += 1
        wall = time.perf_counter() - t0
        finite = [(j, y, s) for j, y, s in done if bool(torch.isfinite(y).all())]
        lat = [s for _, _, s in finite]
        self.win = {"wall_s": wall, "latencies_s": lat,
                    "images": len(lat) * self.batch, "attempted": i,
                    "failed": failed + len(done) - len(finite)}
        self.outputs = [(j, y) for j, y, _ in finite]

    # ---- the traced part ----------------------------------------------------

    def profile(self) -> None:
        """``profile_batches`` more batches under torch.profiler with the
        shape recorder, then the host's time to issue a forward onto an idle
        device."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from benchmark import capture, trace
        n = self.profile_batches
        _sync(self.device)
        with torch.no_grad(), capture.Capture(self.work) as cap, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW):
                for i in range(n):
                    self.forward(self.pool[i % len(self.pool)]).cpu()
                _sync(self.device)
        self.capture = cap
        names = trace.port_kernel_names(ROOT / "fp8_quantization_tpu_torch" / "csrc")
        self.trace = trace.Trace(prof, n, names, self.work)
        issues = []
        with torch.no_grad():
            while sum(issues) < HOST_ISSUE_S or len(issues) < HOST_ISSUES:
                _sync(self.device)
                t0 = time.perf_counter()
                self.forward(self.pool[len(issues) % len(self.pool)])
                issues.append(time.perf_counter() - t0)
            _sync(self.device)
        self.host_issue_s = issues

    # ---- the comparison -----------------------------------------------------

    def sampled(self) -> list:
        """(pool index, program logits) of the window's batches that the
        check compares: ``check_batches`` of them, drawn from the seed."""
        k = min(self.check_batches, len(self.outputs))
        rng = random.Random(f"{self.seed}:check")
        picks = sorted(rng.sample(range(len(self.outputs)), k))
        return [(self.outputs[j][0] % len(self.pool), self.outputs[j][1])
                for j in picks]

    def release(self) -> None:
        """Free the program's state (the model), keeping its inputs."""
        import torch
        self.model = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The compared numbers of the sampled batches against the
        reference (``check.py``)."""
        import torch

        from benchmark import check
        picks = self.sampled()
        if not picks:
            return {}
        x = torch.cat([self.pool[p] for p, _ in picks])
        mbits = self.args.fp8_mantissa_bits
        ref = check.logits(check.reference_model(self.config, self.sd, mbits),
                           self.cal, x)
        wide = check.logits(check.reference_model(self.config, self.sd, mbits,
                                                  wide=True), self.cal, x)
        program = torch.cat([y for _, y in picks]).to(ref.device)
        return check.numbers(program, ref, wide)


def metric_value(name: str, run: Run):
    """The value of metric ``name`` from its reader, None where it finds
    nothing to read."""
    return load_module(BENCH / "metrics" / f"{name}.py").read(run)


def device_info(run: Run, chips: int) -> dict:
    import torch
    if torch.device(run.device).type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                "count": chips,
                "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    if run.trace is not None:
        info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    return info


def drive(run: Run, traced: bool) -> dict:
    """Set-up, window, profile (``traced``), the metrics, and the check;
    the result (the last line's object), or None where a forbidden module
    was loaded."""
    import torch

    from benchmark import check
    run.setup()
    print(json.dumps(run.verdicts()), flush=True)
    print(json.dumps({"build_s": run.times.get("build_s"),
                      "setup_s": run.times["setup_s"],
                      "setup_stages": run.times["stages"]}), flush=True)
    # one host thread for PyTorch's CPU ops while the window and the profile
    # run: no thread pool wakes up beside the dispatch on a shared host
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run.window()
        if traced:
            run.profile()
    finally:
        torch.set_num_threads(threads)
    if forbidden_modules():
        return None
    cell = run.cell
    metrics = {}
    for m in cell.metrics["per_layer" if traced else "end_to_end"]:
        value = metric_value(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = device_info(run, cell.entry["chips"])
    run.release()
    t0 = time.monotonic()
    values = run.check()
    print(json.dumps({"check_readings": values, "check_s": time.monotonic() - t0}),
          flush=True)
    correct, shown = (check.verdict(values, cell.spec["limits"])
                      if values else (False, {}))
    result = {"correct": correct and run.win["failed"] == 0,
              "attempted": run.win["attempted"], "failed": run.win["failed"],
              "metrics": metrics, "device": device}
    if traced:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = shown
    return None if forbidden_modules() else result


def execute(cell: Cell, seed: int, seconds: float, traced: bool,
            t_start: float) -> int:
    """A whole run on the card: prints the result as the last line of
    standard output, each compared number and its limit as the last lines
    of standard error.  Returns the exit status."""
    import torch
    chips = cell.entry["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"{cell.name} needs {chips} CUDA device(s); {have} available",
              file=sys.stderr)
        return 3
    result = drive(Run(cell, seed, seconds, "cuda", t_start), traced)
    if result is None:
        print(f"forbidden modules loaded: {forbidden_modules()}", file=sys.stderr)
        return 4
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def p95(values: list) -> float:
    """The 95th percentile by nearest rank: the least value with at least
    95% of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]
