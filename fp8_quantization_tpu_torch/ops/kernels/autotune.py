"""Measured gating of the fused CUDA kernels.

The counterpart of ``fp8_quantization_tpu/ops/pallas/autotune.py``.  Each
fused route of the ``fused`` engine sits behind a gate: the first time a
shape is seen on the card, the kernel is timed against the composed route
it replaces (what the ``bf16`` engine runs for that layer), and the kernel
is kept only if it wins by ``WIN_MARGIN``.  The verdict is cached in the
process and on disk, and every race is logged at INFO with both times.

Modes (``MODE``, read once from ``FP8TPU_PALLAS_AUTOTUNE``):

* ``auto`` (the default): race on the card; on CPU tensors answer "kernel"
  (its plain version), so that the CPU tests keep the kernel path, as JAX
  does on its CPU backend;
* ``always``: the kernel, without racing;
* ``never``: the composed route.

Each gate carries JAX's name and arguments, plus three keywords: ``like``,
a tensor on the device the layer runs on (``on_card`` decides whether
that is the card), and ``kernel`` and ``composed``, the layer's two
routes as calls on its own input (nn/layers.gated_route).  The race times
those two calls, so it times what the layer runs, with its activation and
output quant, where JAX builds synthetic operands for each probe because it
gates while tracing.  The first layer to meet a key decides for every layer
that shares it, as in JAX.  The CUDA kernels have no image group and no
``k_pad``: the group-valued gates answer 1 (the kernel) or 0 (the composed
route), ``stem_group`` ``(1, 0)`` or ``(0, 0)``, and the callers pass
``g0 = 1``.  ``_CACHE`` uses JAX's key forms: an untagged ``(M, K, N)``
maps to a bool, a tagged key (``c``, ``c2``, ``ig``, ``igp``, ``ig2``,
``igp2``, ``d``, ``d2``, ``s``, ``a``, ``irb...``, and a ``!`` suffix for
JAX's always-mode entries) to an int.  One gate has no JAX counterpart:
``int8_matmul_wins`` (tag ``im``, ``ims`` for an s8 input, ``imse`` for an
s8 input with s8 output) races the int8 1x1 convs and linears against
ops/int8, where JAX takes ops/int8 unraced
outside ``always``; on the H100 the kernel wins there.

The cache file: ``FP8TPU_AUTOTUNE_CACHE`` if set, else
``fp8tpu_torch_autotune_<device name>_<identity hash>.json`` in the
temporary directory (``TMPDIR``).  The identity hash covers the kernel
build (``build.build_hash``: the CUDA sources and flags) and every Python
source of this package, where the composed routes live, so a verdict dies
with either side of the race it came from.

Deliberately not ported:

* the committed seed of verdicts (JAX's ``autotune_seed/``, ``export_seed``)
  and the ``heuristic`` mode (JAX's round-1 TPU shape rule): a seed is
  stale at the next change to either route, which renames the cache, and
  a race costs milliseconds; the shape rule is the TPU's, not the H100's;
* the compile probe that walks the image groups down until the Pallas
  kernel fits in VMEM: the CUDA kernels tile the same way at every batch,
  and there is no VMEM budget to probe;
* ``_off_trace``: eager PyTorch has no ambient trace to step out of;
* every ``except Exception`` around a race.  A kernel that fails to build
  or launch in a race raises, and nothing is cached for that key: a failure
  must never become a verdict for the composed route, which would hide the
  kernel.

Under ``torch.distributed`` with more than one rank (parallel/) the
ranks must take one route, as JAX's one program takes one verdict for
all its devices: rank 0 alone reads the cache file, races and writes it,
and broadcasts each verdict the first time the ranks meet its key
(``_agreed_verdict``), so ``decision_table()`` is the same in every rank
and holds only the keys this run met.

The prepare pass (nn/bake.prepare_inference) asks no gate unless the mode
settles every answer (``settled``): nn/layers.gated_route runs both routes
there instead, so that it records no verdict at the prepare pass's shapes.
"""

from __future__ import annotations

import functools
import hashlib
import json
import logging
import os
import tempfile
from pathlib import Path
from typing import Callable, Dict, Tuple, Union

import torch

from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.utils import timing

logger = logging.getLogger(__name__)

MODES = ("auto", "always", "never")
MODE = os.environ.get("FP8TPU_PALLAS_AUTOTUNE", "auto")

_CACHE: Dict[tuple, Union[bool, int]] = {}
_CACHE_PATH = os.environ.get("FP8TPU_AUTOTUNE_CACHE")   # explicit override
_DISK_LOADED = False
# (kernel s, composed s) of each race run in this process, by key
_TIMES: Dict[tuple, Tuple[float, float]] = {}

# Required kernel-over-composed speedup for a race win (JAX's v5 note: an
# isolated composed baseline is pessimistic, since in a model its passes
# fuse with their neighbours).
WIN_MARGIN = 1.25

_PACKAGE = Path(__file__).resolve().parents[2]


def on_card(like: torch.Tensor) -> bool:
    """Whether a layer runs on the card, where its gate races: its input's
    device.  One attribute read, since every warm forward asks it at each
    gated site; the kernel wrappers check all their operands
    (common.on_card)."""
    return like.is_cuda


def _device_kind() -> str:
    kind = torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"
    return "".join(c if c.isalnum() else "_" for c in kind)


@functools.lru_cache(maxsize=None)
def _python_hash() -> str:
    """A hash of this package's Python sources (the composed routes)."""
    h = hashlib.sha256()
    for p in sorted(_PACKAGE.rglob("*.py")):
        h.update(str(p.relative_to(_PACKAGE)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _identity() -> str:
    """The cache identity: the device's name and a hash of both sides of
    the races, the kernel build and the Python sources."""
    h = hashlib.sha256((build.build_hash() + _python_hash()).encode())
    return f"{_device_kind()}_{h.hexdigest()[:16]}"


def _cache_path() -> str:
    if _CACHE_PATH:
        return _CACHE_PATH
    return os.path.join(tempfile.gettempdir(),
                        f"fp8tpu_torch_autotune_{_identity()}.json")


def decisions() -> Dict[tuple, Union[bool, int]]:
    """The in-process decision log: {key: verdict} (see the module
    docstring for the key forms)."""
    return dict(_CACHE)


def key_name(key: tuple) -> str:
    """A cache key as the cache file writes it: ``"MxKxN"`` for the
    quant-matmul, ``"tag:dims"`` (``"c:64x56x64x64x1"``) for the others."""
    if isinstance(key[0], str):
        return f"{key[0]}:" + "x".join(str(v) for v in key[1:])
    return "x".join(str(v) for v in key)


def decision_table() -> Dict[str, Union[bool, int]]:
    """``decisions()`` with the keys as the cache file writes them."""
    return {key_name(key): win for key, win in _CACHE.items()}


def races() -> Dict[tuple, Tuple[float, float]]:
    """{key: (kernel seconds, composed seconds)} of the races run in this
    process."""
    return dict(_TIMES)


def settled() -> bool:
    """Whether the mode alone answers every gate, whatever the shape and
    the device: ``always`` (the kernel) or ``never`` (the composed
    route)."""
    return MODE in ("always", "never")


def _read_disk_cache() -> Dict[tuple, Union[bool, int]]:
    """The cache file's verdicts ({} without a readable file)."""
    out = {}
    try:
        with open(_cache_path()) as f:
            for key, win in json.load(f).items():
                parts = key.split(":")
                dims = tuple(int(v) for v in parts[-1].split("x"))
                tag = parts[0] if len(parts) > 1 else ""
                # untagged (matmul) entries are bools, tagged ones ints
                out[(tag,) + dims if tag else dims] = int(win) if tag else bool(win)
    except (OSError, ValueError):
        pass
    return out


def _load_disk_cache() -> None:
    global _DISK_LOADED
    _DISK_LOADED = True
    for key, val in _read_disk_cache().items():
        _CACHE.setdefault(key, val)


def _write_disk_cache(entries: Dict[tuple, Union[bool, int]]) -> None:
    try:
        path = _cache_path()
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({key_name(k): v for k, v in entries.items()}, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _save_disk_cache() -> None:
    _write_disk_cache(_CACHE)


def _ranks() -> int:
    """Processes of this run's torch.distributed group (1 without one)."""
    import torch.distributed as dist
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _agreed_verdict(what: str, key: tuple, kernel: Callable,
                    composed: Callable, device) -> Union[bool, int]:
    """Rank 0's verdict for ``key``, broadcast to every rank: rank 0 takes
    it from the cache file or races it (and writes the file); the others
    wait in the broadcast."""
    import torch.distributed as dist
    box = [None]
    if dist.get_rank() == 0:
        disk = _read_disk_cache()
        if key not in disk:
            win = _race(what, key, kernel, composed, device)
            disk[key] = int(win) if isinstance(key[0], str) else win
            _write_disk_cache(disk)
        box = [disk[key]]
    dist.broadcast_object_list(box, 0)
    return box[0]


def _time_fn(fn: Callable, device) -> float:
    """Seconds per call of ``fn``: the best of 3 repetitions of 4 calls,
    after one warm-up call (build and load)."""
    fn()
    return min(timing.time_cuda(fn, iters=4, warmup=0, device=device)
               for _ in range(3))


def _race(what: str, key: tuple, kernel: Callable, composed: Callable,
          device) -> bool:
    """Time ``kernel()`` against ``composed()``; True when the kernel wins
    by ``WIN_MARGIN``.  Logged at INFO with both times."""
    with torch.no_grad():
        t_kernel = _time_fn(kernel, device)
        t_composed = _time_fn(composed, device)
    _TIMES[key] = (t_kernel, t_composed)
    win = t_kernel * WIN_MARGIN < t_composed
    logger.info("%s autotune %s: kernel %.3fms vs composed %.3fms -> %s",
                what, key_name(key), t_kernel * 1e3, t_composed * 1e3,
                "KERNEL" if win else "COMPOSED")
    return win


def _gate(what: str, key: tuple, like: torch.Tensor, kernel: Callable,
          composed: Callable) -> bool:
    """Whether the kernel runs: the mode settles it (``always`` yes,
    ``never`` no); on CPU tensors yes; on the card the cached verdict of
    ``key``, raced the first time (and saved) by timing the two calls.  A
    race that raises caches nothing."""
    if MODE == "always":
        return True
    if MODE == "never":
        return False
    if MODE != "auto":
        raise ValueError(f"FP8TPU_PALLAS_AUTOTUNE={MODE!r}: expected one of "
                         f"{MODES}")
    if not on_card(like):
        return True   # the plain version: keep the kernel path test-covered
    if key in _CACHE:
        return bool(_CACHE[key])
    if _ranks() > 1:
        # every rank runs the same forwards, so meets the same new keys in
        # the same order: each takes rank 0's verdict, and one route
        _CACHE[key] = _agreed_verdict(what, key, kernel, composed, like.device)
        return bool(_CACHE[key])
    if not _DISK_LOADED:
        _load_disk_cache()
    if key not in _CACHE:
        win = _race(what, key, kernel, composed, like.device)
        # untagged (matmul) keys hold bools, tagged ones ints
        _CACHE[key] = int(win) if isinstance(key[0], str) else win
        _save_disk_cache()
    return bool(_CACHE[key])


def pallas_wins(m: int, k: int, n: int, *, like: torch.Tensor,
                kernel: Callable, composed: Callable) -> bool:
    """Should the quant-matmul kernel handle an (M, K) x (K, N) product of a
    1x1 conv or a dense layer?"""
    return _gate("qmatmul", (m, k, n), like, kernel, composed)


def int8_matmul_wins(m: int, k: int, n: int, prequant_x: bool = False,
                     emit_s8: bool = False, *, like: torch.Tensor,
                     kernel: Callable, composed: Callable) -> bool:
    """Should the int8 matmul kernel (qmatmul_int8) handle an (M, K) x
    (K, N) product of an int8 1x1 conv or linear, against ops/int8's
    composed s8 route?  Cache tag 'im', 'ims' for an input already on the
    s8 grid (nn/factored.PrequantS8: the kernel's s8 input against
    ``int8_matmul(x_prequant=True)``), 'imse' for one that also emits its
    result on the next consumer's s8 grid (``emit_s8``: the ViT's gelu
    mlp1); no JAX counterpart."""
    tag = "imse" if emit_s8 else "ims" if prequant_x else "im"
    key = (tag, m, k, n)
    return _gate("qmatmul int8", key, like, kernel, composed)


def conv3_group(n: int, h: int, cin: int, cout: int, g0: int,
                stride: int = 1, *, like: torch.Tensor, kernel: Callable,
                composed: Callable) -> int:
    """1 for the 3x3 conv kernel (qconv), 0 for the composed route.  Cache
    tag 'c' / 'c2' (stride 2)."""
    key = ("c" if stride == 1 else "c2", n, h, cin, cout, g0)
    return int(_gate("conv3", key, like, kernel, composed))


def conv3_int8_group(n: int, h: int, cin: int, cout: int, g0: int,
                     prequant: bool = False, stride: int = 1, *,
                     like: torch.Tensor, kernel: Callable,
                     composed: Callable) -> int:
    """1 for the int8 3x3 conv kernel (qconv_int8), 0 for ops/int8's
    composed s8 route.  Cache tag 'ig' ('igp' with baked int8 weights,
    '2' appended at stride 2)."""
    key = (("igp" if prequant else "ig") + ("2" if stride == 2 else ""),
           n, h, cin, cout, g0)
    return int(_gate("conv3 int8", key, like, kernel, composed))


def dw_group(n: int, h: int, c: int, g0: int, stride: int = 1, *,
             like: torch.Tensor, kernel: Callable, composed: Callable) -> int:
    """1 for the depthwise 3x3 kernel (qdwconv), 0 for the composed route.
    Cache tag 'd' / 'd2' (stride 2)."""
    key = ("d" if stride == 1 else "d2", n, h, c, g0)
    return int(_gate("dw", key, like, kernel, composed))


def stem_group(n: int, s: int, cin: int, cout: int, g0: int, *,
               like: torch.Tensor, kernel: Callable,
               composed: Callable) -> Tuple[int, int]:
    """(1, 0) for the stem kernel (qstem), (0, 0) for the layer and pool
    path; JAX's (group, k_pad), of which the CUDA kernel has neither.
    Cache tag 's'."""
    key = ("s", n, s, cin, cout, g0)
    return int(_gate("stem", key, like, kernel, composed)), 0


def attn_wins(b: int, h: int, s: int, d: int, *, like: torch.Tensor,
              kernel: Callable, composed: Callable) -> bool:
    """Should flash_mha replace the composed softmax chain at this (batch,
    heads, seq, head_dim)?  Cache tag 'a'."""
    return _gate("attn", ("a", b, h, s, d), like, kernel, composed)


def ir_group(n: int, h: int, cin: int, hid: int, cout: int, g0: int,
             stride: int = 1, expand: bool = True, use_res: bool = False, *,
             like: torch.Tensor, kernel: Callable, composed: Callable) -> int:
    """1 for the fused inverted-residual kernel (qblock), 0 for the block's
    three layers (each of which then meets its own gate: the composed
    side of the race is what those gates pick).  Cache tag 'irb' (+ '2'
    at stride 2, 'r' with the residual, 'x' without the expansion)."""
    key = (("irb" + ("2" if stride == 2 else "") + ("r" if use_res else "")
            + ("" if expand else "x")), n, h, cin, hid, cout, g0)
    return int(_gate("ir-block", key, like, kernel, composed))
