"""The port's negative-binomial fits (quaff_tpu_torch/model/negbinom.py)
against the JAX package's (quaff_tpu/model/negbinom.py), and the host
library's evaluations (native/negbinomnat.cpp) against their plain Python
versions.  Tolerance: none.  Both packages run the same libm calls in the
same order, so the fitted (p, r) and every evaluation must be bitwise
equal."""

import numpy as np
import pytest

from quaff_tpu.model import negbinom as jax_nb
from quaff_tpu.model.params import QuaffNullParams as JaxNullParams
from quaff_tpu_torch.io.fastseq import FastSeq
from quaff_tpu_torch.model import negbinom as nb
from quaff_tpu_torch.model.params import QuaffNullParams


@pytest.mark.parametrize("r, p", [(3.0, 0.01), (0.7, 0.05), (20.0, 0.3)])
def test_fit_matches_jax_package(r, p):
    """Read lengths drawn from NB(r, p) with a fixed seed: the same (p, r)
    fit, bit for bit."""
    rng = np.random.default_rng(5)
    k_freq = np.bincount(rng.negative_binomial(r, p, 3000))
    assert nb.fit_negative_binomial(k_freq) == jax_nb.fit_negative_binomial(
        k_freq)


def test_underdispersed_fit_matches_jax_package():
    """Variance below the mean: the moment fit fails and the Newton polish
    may run away; both packages keep the same iterate."""
    k_freq = np.zeros(94)
    k_freq[10] = 50
    k_freq[11] = 50
    assert nb.fit_negative_binomial(k_freq) == jax_nb.fit_negative_binomial(
        k_freq)


def test_null_model_fit_matches_jax_package():
    """The null model's four quality fits on seeded reads with qualities."""
    rng = np.random.default_rng(9)
    reads = []
    for i in range(40):
        n = int(rng.integers(50, 400))
        seq = "".join("ACGT"[t] for t in rng.integers(0, 4, n))
        qual = "".join(chr(33 + int(q)) for q in rng.negative_binomial(6, 0.3, n)
                       .clip(0, 93))
        reads.append((f"r{i}", seq, qual))
    port = QuaffNullParams.fit([FastSeq(name=a, seq=s, qual=q)
                                for a, s, q in reads])
    from quaff_tpu.io.fastseq import FastSeq as JaxFastSeq

    ref = JaxNullParams.fit([JaxFastSeq(name=a, seq=s, qual=q)
                             for a, s, q in reads])
    np.testing.assert_array_equal(port.q, ref.q)
    np.testing.assert_array_equal(port.r, ref.r)
    assert port.null_emit == ref.null_emit


def test_native_matches_plain_bitwise():
    """The C evaluations against the plain Python loops, as
    native/negbinomnat.cpp promises: same libm, same op order."""
    rng = np.random.default_rng(3)
    for trial in range(20):
        freq = rng.gamma(0.5, 10.0, size=94)
        freq[rng.random(94) < 0.3] = 0.0
        p = float(rng.uniform(0.01, 0.99))
        r = float(rng.uniform(0.1, 80.0))
        assert (nb.log_negative_binomial_freq(freq, p, r)
                == nb.log_negative_binomial_freq_plain(freq, p, r)), trial
        assert nb._deriv1(r, freq) == nb._deriv1_plain(r, freq), trial
        assert nb._deriv2(r, freq) == nb._deriv2_plain(r, freq), trial


def test_native_row_matches_scalar_bitwise():
    """log_negative_binomial_array (one C row call) against the scalar
    Python log_negative_binomial, for the score tables' 0..93 and for an
    unordered k."""
    k = np.arange(94)
    shuffled = np.random.default_rng(4).permutation(94)[:30]
    for p, r in ((0.3, 7.7), (0.05, 0.4), (0.97, 55.0)):
        row = nb.log_negative_binomial_array(k, p, r)
        assert [float(v) for v in row] == [
            nb.log_negative_binomial(int(kk), p, r) for kk in k]
        got = nb.log_negative_binomial_array(shuffled, p, r)
        np.testing.assert_array_equal(got, row[shuffled])
        np.testing.assert_array_equal(
            row, jax_nb.log_negative_binomial_array(k, p, r))


def test_failed_build_raises(monkeypatch):
    """The fits have one route, the host library: a library that cannot be
    built raises from the fit, and no Python loop takes over."""
    from quaff_tpu_torch import native

    def broken():
        raise RuntimeError("g++ failed: quaff broken source")

    monkeypatch.setattr(native, "get_lib", broken)
    monkeypatch.setattr(nb, "_NB_NATIVE", None)
    with pytest.raises(RuntimeError, match="quaff broken source"):
        nb._nb_native()
    k_freq = np.bincount(np.random.default_rng(1).negative_binomial(5, 0.1, 500))
    with pytest.raises(RuntimeError, match="quaff broken source"):
        nb.fit_negative_binomial(k_freq)
    with pytest.raises(RuntimeError, match="quaff broken source"):
        nb.log_negative_binomial_array(np.arange(94), 0.3, 7.7)
