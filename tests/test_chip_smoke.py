"""chip_smoke.py's CPU-checkable parts: it refuses to run without a GPU,
and its comparison helpers decide pass and fail correctly."""

import os
import sys

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def test_refuses_without_gpu(capsys):
    assert cs.main([]) == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_check_raises_on_failure(capsys):
    cs.check(True, "fine")
    with pytest.raises(AssertionError, match="broken"):
        cs.check(False, "broken")
    assert "broken: FAILED" in capsys.readouterr().out


def test_rel_close():
    a = np.array([1.0, 2.0, 4.0])
    err, ok = cs.rel_close(a, a * (1 + 5e-6), 1e-5, np.abs(a))
    assert ok and err == pytest.approx(5e-6, rel=1e-3)
    err, ok = cs.rel_close(a, a + np.array([0, 0, 1e-3]), 1e-5, np.abs(a))
    assert not ok and err == pytest.approx(2.5e-4)
    # a zero scale admits a zero difference only
    assert cs.rel_close(np.zeros(2), np.zeros(2), 1e-5, 0.0) == (0.0, True)
    assert not cs.rel_close(np.zeros(2), np.ones(2) * 1e-9, 1e-5, 0.0)[1]


def test_ebv_accuracy_and_simulation():
    X, pheno, bv = cs.simulate(300, 200, 10, seed=1, n_traits=2)
    assert X.shape == (300, 200) and X.dtype == np.float32
    assert set(np.unique(X)) <= {0.0, 1.0, 2.0}
    assert list(pheno.columns) == ["ID", "y1", "y2"] and bv.shape == (300, 2)
    # phenotypic variance is about twice the genetic one at h2 = 0.5
    ratio = pheno["y1"].var() / bv[:, 0].var()
    assert 1.5 < ratio < 2.6
    out = {"EBV_y1": pd.DataFrame({"EBV": bv[:, 0]}),
           "EBV_y2": pd.DataFrame({"EBV": -bv[:, 1]})}
    acc = cs.ebv_accuracy(out, bv, traits=("y1", "y2"))
    assert acc[0] == pytest.approx(1.0) and acc[1] == pytest.approx(-1.0)


def test_posterior_means(tmp_path):
    a = np.arange(12, dtype=float).reshape(3, 4)
    pd.DataFrame(a, columns=list("abcd")).to_csv(
        tmp_path / "MCMC_samples_marker_effects_geno_y.txt", index=False)
    pd.DataFrame({"y_y": [1.0, 2.0, 3.0]}).to_csv(
        tmp_path / "MCMC_samples_residual_variance.txt", index=False)
    m, v = cs.posterior_means(str(tmp_path))
    np.testing.assert_allclose(m, a.mean(axis=0))
    assert v == pytest.approx(2.0)
