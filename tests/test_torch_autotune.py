"""The port's kernel gate (ops/kernels/autotune.py) on the CPU, the
counterpart of tests/test_autotune_cache.py, and utils/timing.

The races run on the card; what the CPU can pin is the machinery around
them: the cache file and its key forms (against the JAX package's writer),
the mode gates (against JAX's on its CPU backend), a reload of the cache
file, the win margin, that a failing kernel raises and caches nothing, the
cache's identity, and that each gate races the two calls it is given
(``on_card`` stubbed to say "card").
"""

import json

import pytest
import torch

import fp8_quantization_tpu.ops.pallas.autotune as jat
from fp8_quantization_tpu_torch.ops.kernels import autotune as at
from fp8_quantization_tpu_torch.ops.kernels import build
from fp8_quantization_tpu_torch.utils import Stopwatch, time_cuda, trace

torch.set_num_threads(1)

CPU = torch.zeros(1)

# every key form, with the port's ints (1 = kernel, 0 = composed)
ENTRIES = {
    (4096, 1024, 1024): True,
    (512, 512, 1000): False,
    ("c", 64, 56, 64, 64, 1): 1,
    ("c2", 64, 56, 64, 128, 1): 0,
    ("c!", 512, 14, 256, 256, 31): 4,       # JAX's always-mode form
    ("ig", 64, 14, 256, 256, 1): 1,
    ("igp", 64, 28, 128, 128, 1): 0,
    ("ig2", 64, 28, 128, 256, 1): 1,
    ("igp2", 64, 56, 64, 128, 1): 0,
    ("im", 12544, 128, 256): 1,             # the port's int8 matmul gate
    ("d", 64, 56, 144, 1): 1,
    ("d2", 64, 112, 96, 1): 0,
    ("s", 64, 224, 3, 64, 1): 1,
    ("a", 64, 6, 197, 64): 0,
    ("irb", 64, 28, 32, 192, 32, 1): 1,
    ("irb2", 64, 56, 24, 144, 32, 1): 0,
    ("irbr", 64, 56, 24, 144, 24, 1): 1,
    ("irbx", 64, 112, 32, 32, 16, 1): 0,
}

# gate -> (the answer a cached verdict v gives, its arguments, the key read)
GATES = {
    "pallas_wins": (bool, (64, 512, 1000), (64, 512, 1000)),
    "int8_matmul_wins": (bool, (12544, 128, 256), ("im", 12544, 128, 256)),
    "conv3_group": (int, (64, 56, 64, 64, 1), ("c", 64, 56, 64, 64, 1)),
    "conv3_int8_group": (int, (64, 14, 256, 256, 1),
                         ("ig", 64, 14, 256, 256, 1)),
    "dw_group": (int, (64, 56, 144, 1), ("d", 64, 56, 144, 1)),
    "stem_group": (lambda v: (int(v), 0), (64, 224, 3, 64, 1),
                   ("s", 64, 224, 3, 64, 1)),
    "attn_wins": (bool, (64, 6, 197, 64), ("a", 64, 6, 197, 64)),
    "ir_group": (int, (64, 28, 32, 192, 32, 1), ("irb", 64, 28, 32, 192, 32, 1)),
}


def _unused(*a, **k):
    pytest.fail("a route ran where the gate should not race")


NO_RACE = dict(like=CPU, kernel=_unused, composed=_unused)


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    monkeypatch.setattr(at, "_CACHE_PATH", str(path))
    monkeypatch.setattr(at, "_CACHE", {})
    monkeypatch.setattr(at, "_TIMES", {})
    monkeypatch.setattr(at, "_DISK_LOADED", False)
    monkeypatch.setattr(at, "MODE", "auto")
    return path


@pytest.fixture
def on_the_card(monkeypatch):
    """Gates answer as on the card (the routes still run on the CPU)."""
    monkeypatch.setattr(at, "on_card", lambda *t: True)


def test_disk_cache_round_trip_all_key_forms(fresh_cache, tmp_path, monkeypatch):
    """Every key form survives save -> load with its type (tagged keys as
    int, untagged as bool), and the file is the one JAX's writer makes of
    the same entries."""
    at._CACHE.update(ENTRIES)
    at._save_disk_cache()
    data = json.loads(fresh_cache.read_text())

    jpath = tmp_path / "jax.json"
    monkeypatch.setattr(jat, "_CACHE_PATH", str(jpath))
    monkeypatch.setattr(jat, "_CACHE", dict(ENTRIES))
    jat._save_disk_cache()
    assert data == json.loads(jpath.read_text()) == at.decision_table()

    at._CACHE.clear()
    at._DISK_LOADED = False
    at._load_disk_cache()
    assert at._CACHE == ENTRIES and at.decisions() == ENTRIES
    for key, val in at._CACHE.items():
        assert type(val) is (int if isinstance(key[0], str) else bool), key


@pytest.mark.parametrize("mode", ["auto", "always", "never"])
def test_mode_gates_on_cpu_tensors_answer_as_jax(mode, fresh_cache, monkeypatch):
    """On CPU tensors: never gives the composed route, auto and always the
    kernel, each as JAX's gate answers on its CPU backend (JAX's stem k_pad
    aside), without running either route; the int8 matmul gate, which JAX
    lacks, answers as pallas_wins."""
    monkeypatch.setattr(at, "MODE", mode)
    monkeypatch.setattr(jat, "MODE", mode)
    monkeypatch.setattr(jat, "_CACHE", {})
    kernel = mode != "never"
    for m, k, n in ((64, 512, 1000), (64 * 56 * 56, 64, 64), (40000, 512, 8),
                    (8, 128, 8)):
        assert at.pallas_wins(m, k, n, **NO_RACE) is kernel
        assert kernel == jat.pallas_wins(m, k, n)
        assert at.int8_matmul_wins(m, k, n, **NO_RACE) is kernel
    answers = {
        "conv3_group": (at.conv3_group(64, 56, 64, 64, 1, **NO_RACE),
                        jat.conv3_group(64, 56, 64, 64, 1)),
        "conv3_int8_group": (
            at.conv3_int8_group(64, 56, 64, 64, 1, prequant=True, **NO_RACE),
            jat.conv3_int8_group(64, 56, 64, 64, 1, prequant=True)),
        "dw_group": (at.dw_group(64, 56, 144, 1, stride=2, **NO_RACE),
                     jat.dw_group(64, 56, 144, 1, stride=2)),
        "stem_group": (at.stem_group(64, 224, 3, 64, 1, **NO_RACE)[0],
                       jat.stem_group(64, 224, 3, 64, 1)[0]),
        "ir_group": (at.ir_group(64, 28, 32, 192, 32, 1, **NO_RACE),
                     jat.ir_group(64, 28, 32, 192, 32, 1)),
        "attn_wins": (at.attn_wins(64, 6, 197, 64, **NO_RACE),
                      jat.attn_wins(64, 6, 197, 64))}
    for name, (port, jax_answer) in answers.items():
        assert port == int(kernel) == jax_answer, name
    assert at.stem_group(64, 224, 3, 64, 1, **NO_RACE)[1] == 0
    assert at.decisions() == {} and not fresh_cache.exists()


@pytest.mark.parametrize("mode", ["heuristic", "bogus"])
def test_unported_mode_raises(mode, fresh_cache, monkeypatch):
    """JAX's ``heuristic`` (its TPU shape rule) is not ported: a mode
    outside auto / always / never raises at the first gate, whatever the
    device, and records nothing."""
    monkeypatch.setattr(at, "MODE", mode)
    with pytest.raises(ValueError, match="FP8TPU_PALLAS_AUTOTUNE"):
        at.conv3_group(64, 56, 64, 64, 1, **NO_RACE)
    assert at.decisions() == {}


def test_cache_file_answers_every_gate_without_racing(fresh_cache,
                                                      monkeypatch,
                                                      on_the_card):
    """A cache file from an earlier process, a cold in-process cache:
    every gate answers from the file, and no race runs."""
    verdicts = {name: i % 2 for i, name in enumerate(GATES)}
    at._CACHE.update({GATES[name][2]: v if isinstance(GATES[name][2][0], str)
                      else bool(v) for name, v in verdicts.items()})
    at._save_disk_cache()
    at._CACHE.clear()
    monkeypatch.setattr(at, "_race", _unused)
    for name, (answer, args, _) in GATES.items():
        assert getattr(at, name)(*args, **NO_RACE) == answer(verdicts[name])
    assert len(at.decisions()) == len(GATES) and at.races() == {}


@pytest.mark.parametrize("t_composed,want", [(1.2, 0), (1.3, 1)])
def test_win_margin(t_composed, want, fresh_cache, monkeypatch, on_the_card):
    """The kernel wins only by WIN_MARGIN: 1.0 against 1.2 keeps the
    composed route, against 1.3 the kernel; the verdict is cached and
    saved, and races() keeps both times."""
    def kernel():
        return CPU

    def composed():
        return CPU

    monkeypatch.setattr(at, "_time_fn",
                        lambda fn, device: 1.0 if fn is kernel else t_composed)
    assert at.WIN_MARGIN == 1.25
    assert at.conv3_group(64, 56, 64, 64, 1, like=CPU, kernel=kernel,
                          composed=composed) == want
    key = ("c", 64, 56, 64, 64, 1)
    assert at.decisions() == {key: want}
    assert json.loads(fresh_cache.read_text()) == {"c:64x56x64x64x1": want}
    assert at.races() == {key: (1.0, t_composed)}


def test_failing_kernel_raises_and_caches_nothing(fresh_cache, on_the_card):
    """A kernel that fails in its race raises out of the gate: no verdict
    for the composed route, nothing in _CACHE or in the file."""
    def broken():
        raise RuntimeError("qmatmul: CUDA error 700 at launch")

    with pytest.raises(RuntimeError, match="CUDA error"):
        at.pallas_wins(16, 32, 16, like=CPU, kernel=broken,
                       composed=lambda: CPU)
    assert at.decisions() == {} and at.races() == {}
    assert not fresh_cache.exists() or "16x32x16" not in fresh_cache.read_text()


def test_cache_identity_follows_both_sides_of_the_race(monkeypatch):
    """The live cache is named by the device and a hash of the kernel
    build and of the package's Python sources (the composed routes): a
    change to either names another file.  FP8TPU_AUTOTUNE_CACHE
    (``_CACHE_PATH``) overrides it."""
    monkeypatch.setattr(at, "_CACHE_PATH", None)
    paths = set()
    for h in ("aaaa", "bbbb"):
        monkeypatch.setattr(build, "build_hash", lambda h=h: h)
        for py in ("1111", "2222"):
            monkeypatch.setattr(at, "_python_hash", lambda py=py: py)
            path = at._cache_path()
            assert "fp8tpu_torch_autotune_cpu_" in path
            paths.add(path)
    assert len(paths) == 4
    monkeypatch.undo()
    assert build._build_dir().name == build.build_hash()
    assert at._python_hash() == at._python_hash() != ""
    monkeypatch.setattr(at, "_CACHE_PATH", "/elsewhere/cache.json")
    assert at._cache_path() == "/elsewhere/cache.json"


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_races_the_two_calls_it_is_given(gate, fresh_cache, on_the_card):
    """Each gate, the first time it meets its key, times the kernel and the
    composed call it was given (a warm-up and 3 x 4 timed calls each),
    caches the verdict under JAX's key form with its type, saves it, and
    keeps both times; the second time it answers from the cache."""
    answer, args, key = GATES[gate]
    calls = {"kernel": 0, "composed": 0}

    def route(name):
        def run():
            calls[name] += 1
            return torch.ones(4, 4) @ torch.ones(4, 4)
        return run

    routes = dict(like=CPU, kernel=route("kernel"), composed=route("composed"))
    first = getattr(at, gate)(*args, **routes)
    assert calls == {"kernel": 13, "composed": 13}
    (raced, (t_kernel, t_composed)), = at.races().items()
    assert raced == key and t_kernel > 0 and t_composed > 0
    verdict = at.decisions()[key]
    assert type(verdict) is (int if isinstance(key[0], str) else bool)
    assert first == answer(verdict)
    assert json.loads(fresh_cache.read_text()) == at.decision_table()
    assert getattr(at, gate)(*args, **routes) == first
    assert calls == {"kernel": 13, "composed": 13}


def test_stopwatch_and_host_timing():
    sw = Stopwatch()
    with sw:
        sum(range(1000))
    first = sw.elapsed
    assert first > 0
    sw.start()
    assert sw.stop() >= first
    sw.reset()
    assert sw.elapsed == 0.0 and sw.stop() == 0.0

    calls = []
    s = time_cuda(lambda x: calls.append(x), CPU, iters=4, warmup=2)
    assert len(calls) == 6 and s >= 0.0
    assert time_cuda(lambda: calls.append(0), iters=3, warmup=0) >= 0.0
    assert len(calls) == 9


def test_trace_profiles_the_block(tmp_path):
    """utils/timing.trace: torch.profiler over the block; with a log_dir
    the trace file is written there."""
    with trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    assert any(tmp_path.iterdir())
