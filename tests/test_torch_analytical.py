"""The analytical SQNR study of the port (BASELINE config 1) against the
JAX package (CPU).

* The port's copies of ``analytical/{distributions,grid,quant_error}.py``
  give bit-equal results (samples, pdfs, bin integrals, moments, grid
  integrals, the expected errors); ``tests/test_analytical.py`` is the
  model.
* ``generate_all_float_values_scaled`` and ``quantizer_grid`` bit-equal,
  for every FP8 format and both uniform grids.
* ``run_study_for_distribution`` at 200,000 samples and 120 candidates:
  the picked ranges equal JAX's and the MSEs agree to rtol 1e-6 (the
  analytic MSE integrates the same grid; the cross-check's empirical side
  sums the same samples' errors in another order).
* The port CLI prints JAX's table, line for line.
"""

import logging

import numpy as np
import pytest
import torch

from fp8_quantization_tpu.analytical import distributions as jdist
from fp8_quantization_tpu.analytical import grid as jgrid
from fp8_quantization_tpu.analytical import quant_error as jqe
from fp8_quantization_tpu.analytical import study as jstudy
from fp8_quantization_tpu.ops import fp8 as jfp8
from fp8_quantization_tpu.ops import quantizer as jq
from fp8_quantization_tpu_torch.analytical import distributions as tdist
from fp8_quantization_tpu_torch.analytical import grid as tgrid
from fp8_quantization_tpu_torch.analytical import quant_error as tqe
from fp8_quantization_tpu_torch.analytical import study as tstudy
from fp8_quantization_tpu_torch.cli import compute_quant_error
from fp8_quantization_tpu_torch.ops import fp8 as tfp8
from fp8_quantization_tpu_torch.ops import quantizer as tq

torch.set_num_threads(1)

DISTS = [("UniformDistribution", dict(range_min=-1.0, range_max=1.0)),
         ("ClippedGaussian", dict(mu=0.3, sigma=1.2, range_min=-8.0, range_max=8.0)),
         ("ClippedStudentT", dict(nu=8.0, range_min=-100.0, range_max=100.0))]


def _pair(name, kw):
    return getattr(jdist, name)(**kw), getattr(tdist, name)(**kw)


@pytest.mark.parametrize("name,kw", DISTS, ids=[d[0] for d in DISTS])
def test_distributions_bit_equal(name, kw):
    jd, td = _pair(name, kw)
    assert jd.describe() == td.describe()
    assert jd.second_moment() == td.second_moment()
    np.testing.assert_array_equal(jd.sample((5000,), np.random.RandomState(3)),
                                  td.sample((5000,), np.random.RandomState(3)))
    x = np.linspace(-3, 3, 101)
    np.testing.assert_array_equal(jd.pdf(x), td.pdf(x))
    np.testing.assert_array_equal(jd.cdf(x), td.cdf(x))
    a, b = np.linspace(-2, 1, 7), np.linspace(-1.5, 2, 7)
    u = 0.5 * (a + b) + 0.1
    np.testing.assert_array_equal(jd.bin_sq_error(a, b, u), td.bin_sq_error(a, b, u))
    np.testing.assert_array_equal(jd.bin_x_weighted_signed(a, b, u),
                                  td.bin_x_weighted_signed(a, b, u))


@pytest.mark.parametrize("name,kw", DISTS, ids=[d[0] for d in DISTS])
def test_grid_and_quant_error_bit_equal(name, kw):
    jd, td = _pair(name, kw)
    grid = jfp8.generate_all_float_values_scaled(8, 4, 8, 6.0)
    for kind in ("sq_error", "x_signed"):
        assert jgrid.integrate_over_grid(jd, grid, kind) == \
            tgrid.integrate_over_grid(td, grid, kind)
    assert jgrid.nearest_grid_value(0.37, grid) == tgrid.nearest_grid_value(0.37, grid)
    xs = np.linspace(-7, 7, 50)
    np.testing.assert_array_equal(jgrid.rounding_error_abs_nearest(xs, grid),
                                  tgrid.rounding_error_abs_nearest(xs, grid))
    assert jqe.expected_rounding_error(jd, grid) == tqe.expected_rounding_error(td, grid)
    assert jqe.expected_signed_error(jd, grid) == tqe.expected_signed_error(td, grid)
    assert jqe.expected_dot_prod_error(jd, grid, jd, grid) == \
        tqe.expected_dot_prod_error(td, grid, td, grid)
    assert jqe.sqnr_db(1e-3) == tqe.sqnr_db(1e-3)
    with pytest.raises(ValueError):
        tgrid.integrate_over_grid(td, grid, "nope")


@pytest.mark.parametrize("mbits", range(1, 8))
def test_scaled_float_grid_bit_equal(mbits):
    ebits = 7 - mbits
    for maxval in (1.0, 3.7, 448.0):
        np.testing.assert_array_equal(
            jfp8.generate_all_float_values_scaled(8, ebits, 2 ** (ebits - 1), maxval),
            tfp8.generate_all_float_values_scaled(8, ebits, 2 ** (ebits - 1), maxval))


@pytest.mark.parametrize("method", ["fp_quantizer", "symmetric_uniform",
                                    "asymmetric_uniform"])
@pytest.mark.parametrize("rng_min,rng_max", [(-5.5, 4.0), (0.0, 3.0)])
def test_quantizer_grid_bit_equal(method, rng_min, rng_max):
    for mbits in (2, 3, 4, 5):
        kw = dict(mantissa_bits=mbits, set_maxval=True, allow_unsigned=True)
        jspec = jq.QuantizerSpec(method=jq.QMethod(method), **kw)
        tspec = tq.QuantizerSpec(method=tq.QMethod(method), **kw)
        jstate = jq.set_quant_range(jspec, jq.init_state(jspec), rng_min, rng_max)
        tstate = tq.set_quant_range(tspec, tq.init_state(tspec),
                                    torch.tensor(rng_min), torch.tensor(rng_max))
        np.testing.assert_array_equal(jq.quantizer_grid(jspec, jstate),
                                      tq.quantizer_grid(tspec, tstate))


@pytest.mark.parametrize("index", range(3), ids=["uniform", "gaussian", "student_t"])
def test_study_rows_match_jax(index):
    """The reference study's distributions at 200,000 samples and 120
    candidates (tests/test_analytical.py's mini study, every format)."""
    jd = jstudy.default_distributions()[index]
    td = tstudy.default_distributions()[index]
    kw = dict(n_samples=200_000, seed=10, num_candidates=120)
    ref = jstudy.run_study_for_distribution(jd, **kw)
    got = tstudy.run_study_for_distribution(td, device="cpu", **kw)
    assert len(got) == len(ref) == 5
    for r, g in zip(ref, got):
        assert (g.distribution, g.exp_bits, g.mantissa_bits) == \
            (r.distribution, r.exp_bits, r.mantissa_bits)
        assert (g.range_min, g.range_max) == (r.range_min, r.range_max)
        for k in ("quant_mse", "dot_prod_mse", "quant_sqnr_db", "dot_prod_sqnr_db"):
            np.testing.assert_allclose(getattr(g, k), getattr(r, k), rtol=1e-6)


def test_gaussian_study_cross_validates(caplog):
    """JAX's ``test_mini_study_runs_and_cross_validates`` on the port: the
    analytic/empirical cross-check stays quiet on the Gaussian and E2M5
    beats E5M2."""
    d = tstudy.default_distributions()[1]
    with caplog.at_level(logging.WARNING, logger=tqe.log.name):
        res = tstudy.run_study_for_distribution(d, n_samples=150_000, seed=10,
                                                num_candidates=120, device="cpu")
    assert not [r for r in caplog.records if "differ" in r.getMessage()]
    by_exp = {r.exp_bits: r.quant_sqnr_db for r in res}
    assert by_exp[2] > by_exp[5]


def test_cli_prints_jax_table(capsys, monkeypatch):
    """The port CLI's table is JAX's ``run_full_study`` output, line for
    line (20,000 samples, 40 candidates); without --device cpu it needs
    CUDA."""
    lines = []
    jstudy.run_full_study(n_samples=20_000, seed=10, num_candidates=40,
                          printer=lines.append)
    ref = "\n".join(lines).splitlines()
    compute_quant_error.main(["--device", "cpu", "--n-samples", "20000",
                              "--num-candidates", "40"])
    assert capsys.readouterr().out.splitlines() == ref
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_quant_error.main(["--n-samples", "1000"])


def test_line_search_range_sample_device_move():
    """The study's line search on a torch tensor equals it on numpy."""
    from fp8_quantization_tpu_torch.calibration.line_search import line_search_range
    x = np.random.RandomState(2).normal(0, 1, 20_000).astype(np.float32)
    spec = tq.QuantizerSpec(method=tq.QMethod.fp_quantizer, mantissa_bits=3,
                            set_maxval=True)
    assert line_search_range(torch.from_numpy(x), spec, num_candidates=50) == \
        line_search_range(x, spec, num_candidates=50)
