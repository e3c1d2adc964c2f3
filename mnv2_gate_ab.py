"""What MobileNetV2's t=1 block costs a forward on each route of its kernel gate.

MobileNetV2 FP8 ``fp32_after`` at batch 64 on 'fused', baked and prepared as chip_smoke.py's
phases build it, under the gate's ``auto`` mode from an empty cache in a temporary file: after
one forward (the races), the forward with the first block (t = 1, its race near the 1.25
margin) on its two layers (verdict 0) against on qblock (verdict 1) and against ``always``, in
10 alternating rounds of 10 forwards: wall ms (chip_smoke.time_ms), the median over rounds of
layers over qblock, then device ms alone (chip_smoke.kernel_ms) and the launches of one forward
each.  Prints one JSON line.  Needs one card:

    python3 mnv2_gate_ab.py
"""
import json
import os
import statistics
import sys
import tempfile

import chip_smoke as cs


def main():
    import torch
    from fp8_quantization_tpu_torch.nn.bake import bake_weights, prepare_inference
    from fp8_quantization_tpu_torch.ops import kernels
    from fp8_quantization_tpu_torch.ops.kernels import autotune, build
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32
    build.build_all()
    tmp = tempfile.TemporaryDirectory()
    autotune._CACHE_PATH = os.path.join(tmp.name, "cache.json")
    autotune._CACHE, autotune._DISK_LOADED, autotune.MODE = {}, False, "auto"
    out = {"nvidia_smi": cs.smi_line()}
    with tmp, no_tf32(), torch.no_grad():
        batches, fused, _ = cs.engine_pair(cs.mnv2_cli_args("fp32_after"))
        bake_weights(fused)
        x = torch.as_tensor(batches[0][0], device="cuda")
        prepare_inference(fused, torch.zeros((1,) + tuple(x.shape[1:]), device="cuda"),
                          quant_w=False)
        fused(x, mode="fixed", quant_w=False)          # the races
        key = next(k for k in autotune.decisions() if str(k[0]).startswith("irbx"))
        out["race"] = {"key": autotune.key_name(key), "verdict": autotune.decisions()[key],
                       "kernel_ms": autotune.races()[key][0] * 1e3,
                       "composed_ms": autotune.races()[key][1] * 1e3}
        settings = {"auto_block_layers": ("auto", 0), "auto_block_kernel": ("auto", 1),
                    "always": ("always", None)}

        def use(name):
            autotune.MODE, verdict = settings[name]
            if verdict is not None:
                autotune._CACHE[key] = verdict

        def fwd():
            return fused(x, mode="fixed", quant_w=False)

        wall = {n: [] for n in settings}
        for r in range(10):
            for n in (list(settings) if r % 2 == 0 else list(settings)[::-1]):
                use(n)
                wall[n].append(cs.time_ms(fwd, iters=10))
        out["wall_ms_median"] = {n: statistics.median(v) for n, v in wall.items()}
        out["wall_ms_best"] = {n: min(v) for n, v in wall.items()}
        out["wall_ms_rounds"] = wall
        out["layers_over_kernel_paired"] = statistics.median(
            a / b for a, b in zip(wall["auto_block_layers"], wall["auto_block_kernel"]))
        out["device_ms"], out["launches"] = {}, {}
        for n in settings:
            use(n)
            out["device_ms"][n] = cs.kernel_ms(fwd, iters=10)
            kernels.reset_launch_counts()
            fwd()
            torch.cuda.synchronize()
            out["launches"][n] = {k: v for k, v in kernels.launch_counts().items() if v}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
