"""Network-wide FP8 format allocation by coordinate descent.

Mirrors ``fp8_quantization_tpu/calibration/format_search.py``: each FP8
quantizer's mantissa bits (the exponent/mantissa split of its 8 bits) are
chosen in turn to minimize the mean squared difference between the
quantized model's logits and the float32 model's, summed over the given
batches.  The incumbent is always a candidate, so no step raises that
error.  Only ``mantissa_bits`` changes; the ranges stay as calibrated.

Quantizers are visited in the JAX package's order: sorted by their path in
the ``quant`` collection, which is the port's module path plus ``q``
(``layer1_0.conv1.weight_q`` -> ``layer1_0/conv1/weight_q/q``), the key of
the returned assignment.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from fp8_quantization_tpu_torch.parallel import collectives

log = logging.getLogger(__name__)


def find_fp8_quantizers(model) -> List[Tuple[str, object]]:
    """(collection path, quantizer) of every FP8 quantizer of ``model``,
    sorted by path as JAX's ``find_fp8_quantizers`` traverses them."""
    from fp8_quantization_tpu_torch.nn.quantizers import Quantizer
    found = [(tuple(name.split(".")) + ("q",), m)
             for name, m in model.named_modules()
             if isinstance(m, Quantizer) and m.spec.is_fp8]
    return [("/".join(path), m) for path, m in sorted(found, key=lambda t: t[0])]


@torch.no_grad()
def network_format_search(model, batches: Iterable, *, device,
                          candidates: Sequence[int] = (2, 3, 4, 5),
                          passes: int = 1, quant_w: bool = True,
                          quant_a: bool = True
                          ) -> Tuple[object, Dict[str, int], List[float]]:
    """Coordinate descent over the FP8 quantizers' mantissa bits of a
    calibrated ``model`` (in place).

    Returns ``(model, {path: mantissa bits}, [network MSE before, after
    each pass])``.
    """
    xs = [torch.as_tensor(np.asarray(b[0] if isinstance(b, (tuple, list)) else b))
          .to(device=device, dtype=torch.float32) for b in batches]
    if not xs:
        raise ValueError("format search needs at least one batch")
    refs = [model(x, mode="fixed", quant_w=False, quant_a=False) for x in xs]

    def total_mse():
        s = torch.zeros((), device=device)
        for x, r in zip(xs, refs):
            out = model(x, mode="fixed", quant_w=quant_w, quant_a=quant_a)
            s = s + torch.mean((out - r) ** 2)
        if collectives.active():    # each rank holds its rows: their mean
            s = collectives.all_sum(s) / collectives.size()
        return s

    quantizers = find_fp8_quantizers(model)
    if not quantizers:
        log.warning("format search: no FP8 quantizer state found")
        return model, {}, []
    cur_mse = total_mse()
    history = [float(cur_mse)]
    log.info("format search: %d quantizers, %d candidates, initial network "
             "MSE %.3e", len(quantizers), len(candidates), history[0])
    for p in range(passes):
        for path, qz in quantizers:
            mb = qz.mantissa_bits
            cur = float(mb)
            cand_ms = [float(m) for m in candidates if float(m) != cur]
            losses = [cur_mse]
            for m in cand_ms:
                mb.fill_(m)
                losses.append(total_mse())
            mb.fill_(cur)
            losses_t = torch.stack(losses)
            losses_h = losses_t.cpu().numpy()
            k = int(losses_h.argmin())
            if k > 0:
                mb.fill_(cand_ms[k - 1])
                log.info("format search: %s M=%d -> M=%d (MSE %.3e)", path,
                         int(cur), int(cand_ms[k - 1]), losses_h[k])
            cur_mse = losses_t[k]
        history.append(float(cur_mse))
        log.info("format search pass %d done: network MSE %.3e", p + 1,
                 history[-1])
    assignment = {path: int(float(qz.mantissa_bits)) for path, qz in quantizers}
    return model, assignment, history
