"""The benchmark's part for the port's flash attention, on the CPU: its
work function (``work/flash_mha.py``) against bytes and operations
reckoned by hand, and the shape recorder around the port's wrapper."""

import pytest
import torch

from benchmark import capture, harness, peaks

WORK = harness.BENCH / "work" / "flash_mha.py"
SHAPE = (2, 2, 197, 64)
ELEMENTS = 2 * 2 * 197 * 64                 # 50,432 of each operand
OPS = 4 * 2 * 2 * 197 * 197 * 64            # the two products: 39,740,416


def _separate(dtype):
    return tuple(torch.zeros(SHAPE, dtype=dtype) for _ in range(3))


def _views_of_qkv(dtype):
    """(B, H, S, D) views of one (B, S, 3, H, D) qkv output, as the ViT hands
    them to the kernel: each counts its own elements, not the buffer's."""
    qkv = torch.zeros(2, 197, 3, 2, 64, dtype=dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


@pytest.mark.parametrize("operands", [_separate, _views_of_qkv])
@pytest.mark.parametrize("dtype, size", [(torch.float32, 4), (torch.bfloat16, 2)])
def test_work_by_hand(operands, dtype, size):
    moved, ops, datapath = harness.load_module(WORK).work(operands(dtype), {})
    assert moved == 3 * ELEMENTS * size + 4 * ELEMENTS
    assert ops == OPS == 39_740_416 and datapath == "bf16"


def test_capture_records_the_calls():
    """The recorder wraps the port's ``attention.flash_mha`` where the ViT
    looks it up, counts each call by its shapes, and restores it."""
    from fp8_quantization_tpu_torch.ops.kernels import attention
    saved = attention.flash_mha
    q = torch.randn(SHAPE)
    with capture.Capture({"flash_mha": harness.load_module(WORK)}) as cap:
        for _ in range(3):
            attention.flash_mha(q, q, q, sm_scale=0.125)
    assert attention.flash_mha is saved
    (moved, ops, datapath, uses), = cap.calls["flash_mha"].values()
    assert uses == 3 and moved == 4 * ELEMENTS * 4 and ops == OPS
    assert cap.least_seconds("flash_mha") == pytest.approx(
        3 * peaks.least_seconds(moved, ops, datapath))
