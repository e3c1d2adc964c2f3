#!/usr/bin/env python3
"""Where the ViT-S/16 INT8 forward's device time goes, per checkout of the
PyTorch/CUDA port, on one GPU.

    python3 vit_int8_probe.py CHECKOUT [CHECKOUT ...]

One process per checkout, in the order given.  Each imports that
checkout's ``chip_smoke.py`` and runs its ``vit_int8_slice`` phase (the
ViT-S/16 INT8 main path through ``validate-quantized`` at batch 64, random
weights from seed 0, synthetic data, then the deployed ``fused`` model,
int8-baked and prepared), profiles three forwards of that model after a
warm one (``chip_smoke.profile_forwards``: device ms per forward by
kernel, launches, the idle share of the wall time) and times mlp1's int8
matmul as the forward calls it (``chip_smoke.kernel_ms``): the composed
``ops/int8.int8_matmul`` route where the checkout runs mlp1 there, the
kernel where it runs mlp1 on one.  One JSON line per checkout, then the
``nvidia-smi`` name / power-limit line.
"""

import json
import os
import subprocess
import sys

KERNELS = ("qmatmul_s8_sm90", "qmatmul_int8", "flash_mha")


def child(checkout):
    """Profile one checkout's ViT-S INT8 forward; print one JSON line."""
    root = os.path.abspath(checkout)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from fp8_quantization_tpu_torch.ops import int8 as int8_ops
    from fp8_quantization_tpu_torch.ops.kernels import autotune, build, qmatmul_int8
    from fp8_quantization_tpu_torch.ops.kernels.common import no_tf32

    build.build_all()
    autotune.MODE = "always"
    with no_tf32():
        ok, fused, _ = cs.phase_vit_int8_slice({})
        x = torch.randn(cs.BATCH, 224, 224, 3, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(2))
        rows, wall = cs.profile_forwards(fused, x, True)
        busy = sum(r[1] for r in rows)
        ours = {k: sum(r[1] for r in rows if k + "_kernel" in r[0]) for k in KERNELS}
        # mlp1's call: the one that emits s8 (its e_scalars, or emit_s8)
        seen = {}
        routes = ((int8_ops, "int8_matmul", "composed", "emit_s8"),
                  (qmatmul_int8, "fused_quant_matmul_int8", "kernel", "e_scalars"))
        saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in routes]
        for (mod, name, label, key), (_, _, fn) in zip(routes, saved):
            def spy(*a, _fn=fn, _label=label, _key=key, **kw):
                if kw.get(_key) is not None:
                    seen.setdefault(_label, [a, kw, _fn, 0])[3] += 1
                return _fn(*a, **kw)
            for count in ("launches", "s8_launches", "sm90_launches"):
                if hasattr(fn, count):
                    setattr(spy, count, getattr(fn, count))
            setattr(mod, name, spy)
        with torch.no_grad():
            fused(x, mode="fixed", quant_w=True)
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        mlp1 = {}
        with torch.no_grad():
            for label, (a, kw, fn, calls) in seen.items():
                ms = cs.kernel_ms(lambda: fn(*a, **kw), iters=5)
                mlp1[label] = {"calls_per_forward": calls, "ms_per_call": ms,
                               "ms_per_forward": ms * calls}
    print(json.dumps({
        "checkout": checkout, "vit_int8_slice_ok": ok, "wall_ms_per_forward": wall,
        "device_busy_ms_per_forward": busy,
        "idle_share": max(0.0, 1.0 - busy / wall) if rows else "not measured",
        "launches_per_forward": sum(r[2] for r in rows), "port_kernels_ms": ours,
        "pytorch_ms": busy - sum(ours.values()), "mlp1": mlp1,
        "top": [{"name": r[0][:90], "ms": r[1], "calls": r[2]}
                for r in sorted(rows, key=lambda r: -r[1])[:12]]}), flush=True)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--child":
        child(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for checkout in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", checkout],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"checkout"')]
        print(lines[-1] if lines else json.dumps({"checkout": checkout, "rc": proc.returncode,
                                                  "stderr": proc.stderr[-2000:]}), flush=True)
        rc |= proc.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
