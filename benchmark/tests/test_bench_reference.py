"""The plain reference against the port's CPU path on tiny models (the
only file that imports both): the calibrated ranges agree, the logits lie
at the reference's own rounding floor, and the control does not."""

import pytest
import torch

from benchmark import check, traffic
from benchmark.arch import resnet as resnet_arch
from benchmark.arch import vit as vit_arch

TINY = {
    "resnet": {"stages": [1, 1, 1, 1], "widths": [64, 128, 256, 512],
               "classes": 10, "image_size": 32},
    "vit": {"dim": 64, "depth": 2, "heads": 2, "mlp_ratio": 4, "patch": 8,
            "image_size": 32, "classes": 10},
}


def _port_model(arch: str, sd: dict):
    from fp8_quantization_tpu_torch.models import convert
    from fp8_quantization_tpu_torch.models.resnet import QuantizedResNet
    from fp8_quantization_tpu_torch.models.vit import QuantizedViT
    from fp8_quantization_tpu_torch.nn.config import make_layer_config
    cfg = make_layer_config(qmethod="fp_quantizer", per_channel_weights=True,
                            fp8_set_maxval=True, fp8_mantissa_bits=4,
                            weight_range_method="current_minmax",
                            act_range_method="allminmax", engine="fused")
    m = TINY[arch]
    host = {k: v.numpy() for k, v in sd.items()}
    if arch == "resnet":
        model = QuantizedResNet(m["stages"], True, m["classes"], config=cfg)
        convert.load_torchvision_resnet(model, host)
    else:
        model = QuantizedViT(num_classes=m["classes"], patch_size=m["patch"],
                             dim=m["dim"], depth=m["depth"], num_heads=m["heads"],
                             mlp_ratio=m["mlp_ratio"], image_size=m["image_size"],
                             config=cfg)
        convert.load_timm_vit(model, host)
    return model.eval()


def _port_name(arch: str, name: str) -> str:
    """The port's module of the reference's quantizer ``name``."""
    if arch == "resnet":
        if name in ("conv1", "fc"):
            return {"conv1": "stem", "fc": "fc"}[name]
        stage, block, rest = name.split(".", 2)
        base = f"{stage}_{block}"
        return {"act": base + "_act", "downsample.0": base + "_downsample"}.get(
            rest, f"{base}.{rest}")
    fixed = {"patch_embed.proj": "patch_embed", "norm": "ln_final", "head": "head"}
    if name in fixed:
        return fixed[name]
    _, i, rest = name.split(".", 2)
    return f"block{i}." + {"norm1": "ln1", "norm2": "ln2", "res1": "res1_act",
                           "res2": "res2_act", "mlp.fc1": "mlp1",
                           "mlp.fc2": "mlp2"}.get(rest, rest)


@pytest.mark.parametrize("arch", ["resnet", "vit"])
def test_reference_against_the_port(arch):
    from fp8_quantization_tpu_torch.calibration.calibrate import calibrate
    from fp8_quantization_tpu_torch.nn.bake import bake_for_inference, prepare_inference
    mod = {"resnet": resnet_arch, "vit": vit_arch}[arch]
    spec = {"size": 32, "coarse": 7, "coarse_std": 1.0, "noise_std": 0.25}
    sd = mod.draw(TINY[arch], traffic.generator(7, "weights", "cpu"), "cpu")
    cal = traffic.images(spec, 16, traffic.generator(7, "calibration", "cpu"), "cpu")
    x = traffic.images(spec, 32, traffic.generator(7, "pool", "cpu"), "cpu")

    model = _port_model(arch, sd)
    calibrate(model, [cal], device="cpu", num_batches=1)
    quant_w = bake_for_inference(model)
    prepare_inference(model, torch.zeros(1, 32, 32, 3), quant_w=quant_w, quant_a=True)
    with torch.no_grad():
        program = model(x, mode="fixed", quant_w=quant_w, quant_a=True)

    config = {"architecture": arch, "model": TINY[arch], "datapath": "bf16"}
    ref_model = check.reference_model(config, sd, 4)
    ref = check.logits(ref_model, [cal], x)
    wide = check.logits(check.reference_model(config, sd, 4, wide=True), [cal], x)
    low = check.logits(check.reference_model(config, sd, 4, "e4m3"), [cal], x)

    # the first quantizers' ranges agree to rounding; deeper ones may take
    # their largest value from an element that chaos moved, by less than one
    # E3M4 step (2^-4 of the value)
    for i, (name, ours) in enumerate(ref_model.q.act_max.items()):
        theirs = model.get_submodule(_port_name(arch, name)).act_q.maxval
        rel = abs(float(ours) / float(theirs) - 1)
        assert rel < (1e-6 if i < 4 else 2.0 ** -4), (name, rel)

    sound = check.numbers(program, ref, wide)
    control = check.numbers(low, ref, wide)
    assert sound["excess"] < 0.5, sound
    assert control["excess"] > max(3.0, 10 * sound["excess"]), (sound, control)
    assert control["row_excess"] > sound["row_excess"], (sound, control)
