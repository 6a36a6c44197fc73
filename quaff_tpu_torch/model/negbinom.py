"""Negative-binomial quality-score model and maximum-likelihood fitting.

Reimplements the reference's three-stage fit (src/negbinom.cpp:112-129,
the Crowley method): method-of-moments initialisation, Brent bracketing of
the stationary point of the profile log-likelihood in nSuccess (with the
success probability profiled out in closed form), and a Newton polish.
The same convergence constants and fallback/runaway behaviours are kept so
fitted (p, r) values agree with the reference to within its own stopping
tolerances.  digamma/trigamma are implemented with recurrence shifts plus
asymptotic series (no GSL / scipy dependency).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from typing import Tuple

import numpy as np

# CPython's math.lgamma is its own Lanczos implementation, NOT libm's —
# off by ulps from the std::lgamma the reference binary calls.  Bitwise
# score-table parity (round-4 tie-class fix) needs the exact libm bits,
# so call glibc's lgamma directly.
_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_libm.lgamma.restype = ctypes.c_double
_libm.lgamma.argtypes = [ctypes.c_double]
_lgamma = _libm.lgamma

# The host library (native/negbinomnat.cpp) carries the profile-likelihood
# evaluations; the Python loops below (*_plain) are their plain versions,
# BITWISE identical (same libm calls, same op order; pinned by
# tests/test_torch_negbinom.py) and ~100x slower, kept for the tests only.
# The library is resolved at first use, so that importing this module
# builds nothing; a library that cannot be built raises, as everywhere in
# the port.
_NB_NATIVE = None


def _nb_native() -> ctypes.CDLL:
    global _NB_NATIVE
    if _NB_NATIVE is None:
        from .. import native as _native

        lib = _native.get_lib()
        f64 = ctypes.c_double
        f64p = ctypes.POINTER(ctypes.c_double)
        i64 = ctypes.c_int64
        lib.qdp_lognb_freq.restype = f64
        lib.qdp_lognb_freq.argtypes = [f64p, i64, f64, f64]
        lib.qdp_nb_deriv1.restype = f64
        lib.qdp_nb_deriv1.argtypes = [f64p, i64, f64]
        lib.qdp_nb_deriv2.restype = f64
        lib.qdp_nb_deriv2.argtypes = [f64p, i64, f64]
        lib.qdp_lognb_row.restype = None
        lib.qdp_lognb_row.argtypes = [f64p, i64, f64, f64]
        _NB_NATIVE = lib
    return _NB_NATIVE


def _as_f64_ptr(arr: np.ndarray):
    a = np.ascontiguousarray(arr, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

# convergence parameters (negbinom.cpp:12-17)
BRACKET_MAX_ITER = 100
BRACKET_ABS_ERR = 1e-3
BRACKET_REL_ERR = 1e-3
POLISH_MAX_ITER = 100
POLISH_ABS_ERR = 0.0
POLISH_REL_ERR = 1e-4


# ---------------------------------------------------------------------------
# special functions


def _digamma(x: float) -> float:
    """psi(x) for x > 0, ~1e-14 accuracy (recurrence shift + asymptotics)."""
    result = 0.0
    while x < 10.0:
        result -= 1.0 / x
        x += 1.0
    inv = 1.0 / x
    inv2 = inv * inv
    # asymptotic expansion: ln x - 1/2x - sum B_2n / (2n x^{2n})
    series = (
        inv2
        * (
            -1.0 / 12.0
            + inv2
            * (
                1.0 / 120.0
                + inv2
                * (
                    -1.0 / 252.0
                    + inv2
                    * (1.0 / 240.0 + inv2 * (-1.0 / 132.0 + inv2 * (691.0 / 32760.0)))
                )
            )
        )
    )
    return result + math.log(x) - 0.5 * inv + series


def _trigamma(x: float) -> float:
    """psi'(x) for x > 0."""
    result = 0.0
    while x < 10.0:
        result += 1.0 / (x * x)
        x += 1.0
    inv = 1.0 / x
    inv2 = inv * inv
    series = inv * (
        1.0
        + inv * (0.5 + inv * (1.0 / 6.0 + inv2 * (-1.0 / 30.0 + inv2 * (1.0 / 42.0 + inv2 * (-1.0 / 30.0)))))
    )
    return result + series


def log_negative_binomial(k: int, p_success: float, n_success: float) -> float:
    """log NB(k; p, n) with the GSL parameterisation:
    pdf(k) = Gamma(n+k) / (Gamma(k+1) Gamma(n)) * p^n * (1-p)^k

    Mirrors the reference's exact op sequence (negbinom.cpp:30 calls
    log(gsl_ran_negative_binomial_pdf(...)), i.e. the log-gamma exponent is
    built left-to-right as ((lgamma(k+n) - lgamma(n)) - lgamma(k+1))
    + n*log(p) + k*log1p(-p), then ROUND-TRIPPED through exp and log).
    The round trip costs up to a few hundred ulps but the reference's
    Viterbi tie-breaking depends on the exact bits, so we replicate it
    (round-4 tie-class parity fix).
    """
    f = _lgamma(k + n_success)
    a = _lgamma(n_success)
    b = _lgamma(k + 1.0)
    core = ((f - a) - b) + n_success * math.log(p_success) + k * math.log1p(
        -p_success
    )
    return math.log(math.exp(core))


def log_negative_binomial_array(
    k: np.ndarray, p_success: float, n_success: float
) -> np.ndarray:
    """log NB(k; p, n) over an array of non-negative integers k with scalar
    (p, n): one native row call (qdp_lognb_row) for 0..max(k), each entry
    bitwise identical to log_negative_binomial."""
    k = np.asarray(k, dtype=np.int64)
    out = np.empty(int(k.max(initial=-1)) + 1, dtype=np.float64)
    _nb_native().qdp_lognb_row(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(out), float(p_success), float(n_success),
    )
    return out[k]


def log_negative_binomial_freq(k_freq: np.ndarray, p_success: float, n_success: float) -> float:
    """sum_k freq[k] * log NB(k; p, n), accumulated sequentially over ALL k
    exactly as the reference loop does (negbinom.cpp:34-39) — including
    zero-frequency terms, whose 0*logNB products reproduce the reference's
    NaN semantics when logNB underflows to -inf."""
    a, ptr = _as_f64_ptr(k_freq)
    return float(
        _nb_native().qdp_lognb_freq(ptr, len(a), float(p_success),
                                    float(n_success))
    )


def log_negative_binomial_freq_plain(k_freq: np.ndarray, p_success: float,
                                     n_success: float) -> float:
    """The plain version of log_negative_binomial_freq."""
    lp = 0.0
    for k in range(len(k_freq)):
        lp += float(k_freq[k]) * log_negative_binomial(k, p_success, n_success)
    return lp


def negative_binomial_mean(p_success: float, n_success: float) -> float:
    return n_success * (1.0 - p_success) / p_success


def negative_binomial_variance(p_success: float, n_success: float) -> float:
    return n_success * (1.0 - p_success) / (p_success * p_success)


# ---------------------------------------------------------------------------
# profile likelihood in n (p profiled out)


def _moments(k_freq: np.ndarray) -> Tuple[float, float, float]:
    k = np.arange(len(k_freq), dtype=np.float64)
    count = float(np.sum(k_freq))
    if count <= 0:
        return 0.0, float("nan"), float("nan")
    mean = float(np.dot(k_freq, k)) / count
    variance = float(np.dot(k_freq, k * k)) / count - mean * mean
    return count, mean, variance


def optimal_success_prob(n_success: float, k_freq: np.ndarray) -> float:
    k = np.arange(len(k_freq), dtype=np.float64)
    freq_sum = float(np.sum(k_freq))
    k_sum = float(np.dot(k_freq, k))
    return 1.0 / (1.0 + k_sum / (freq_sum * n_success))


def _profile_loglike(n: float, k_freq: np.ndarray) -> float:
    p = optimal_success_prob(n, k_freq)
    return log_negative_binomial_freq(k_freq, p, n)


def _deriv1(n: float, k_freq: np.ndarray) -> float:
    a, ptr = _as_f64_ptr(k_freq)
    return float(_nb_native().qdp_nb_deriv1(ptr, len(a), float(n)))


def _deriv1_plain(n: float, k_freq: np.ndarray) -> float:
    """The plain version of _deriv1."""
    freq_sum = 0.0
    k_sum = 0.0
    k_digamma_sum = 0.0
    for k in np.nonzero(k_freq)[0]:
        freq = float(k_freq[k])
        freq_sum += freq
        k_sum += freq * k
        k_digamma_sum += freq * _digamma(n + k)
    return (
        -freq_sum * math.log(1.0 + k_sum / (freq_sum * n))
        - freq_sum * _digamma(n)
        + k_digamma_sum
    )


def _deriv2(n: float, k_freq: np.ndarray) -> float:
    a, ptr = _as_f64_ptr(k_freq)
    return float(_nb_native().qdp_nb_deriv2(ptr, len(a), float(n)))


def _deriv2_plain(n: float, k_freq: np.ndarray) -> float:
    """The plain version of _deriv2."""
    freq_sum = 0.0
    k_trigamma_sum = 0.0
    for k in np.nonzero(k_freq)[0]:
        freq = float(k_freq[k])
        freq_sum += freq
        k_trigamma_sum += freq * _trigamma(n + k)
    return -freq_sum * _trigamma(n) + k_trigamma_sum


# ---------------------------------------------------------------------------
# solvers


def _test_interval(lo: float, hi: float, epsabs: float, epsrel: float) -> bool:
    abs_lo, abs_hi = abs(lo), abs(hi)
    if (lo > 0 and hi > 0) or (lo < 0 and hi < 0):
        min_abs = min(abs_lo, abs_hi)
    else:
        min_abs = 0.0
    return abs(hi - lo) < epsabs + epsrel * min_abs


def _brent(f, lo: float, hi: float, max_iter: int, epsabs: float, epsrel: float) -> float:
    """Brent's method, structured like GSL's root bracketing solver.

    Assumes f(lo) and f(hi) have opposite signs; returns the root estimate
    after the interval convergence test (abs/rel) passes, as the reference's
    loop does (negbinom.cpp:216-243).
    """
    a, b = lo, hi
    fa, fb = f(a), f(b)
    c, fc = b, fb
    d = b - a
    e = b - a
    root = b
    for _ in range(max_iter):
        ac_equal = False
        if (fb < 0 and fc < 0) or (fb > 0 and fc > 0):
            ac_equal = True
            c, fc = a, fa
            d = b - a
            e = b - a
        if abs(fc) < abs(fb):
            ac_equal = True
            a, b, c = b, c, b
            fa, fb, fc = fb, fc, fb
        tol = 0.5 * 2.220446049250313e-16 * abs(b)
        m = 0.5 * (c - b)
        if fb == 0.0:
            return b
        if abs(m) <= tol:
            return b
        if abs(e) < tol or abs(fa) <= abs(fb):
            d = m
            e = m
        else:
            s = fb / fa
            if ac_equal:
                p = 2.0 * m * s
                q = 1.0 - s
            else:
                q = fa / fc
                r = fb / fc
                p = s * (2.0 * m * q * (q - r) - (b - a) * (r - 1.0))
                q = (q - 1.0) * (r - 1.0) * (s - 1.0)
            if p > 0:
                q = -q
            else:
                p = -p
            if 2.0 * p < min(3.0 * m * q - abs(tol * q), abs(e * q)):
                e = d
                d = p / q
            else:
                d = m
                e = m
        a, fa = b, fb
        if abs(d) > tol:
            b += d
        else:
            b += tol if m > 0 else -tol
        fb = f(b)
        root = b
        # interval for convergence test
        if (fb < 0 and fc < 0) or (fb > 0 and fc > 0):
            lo_i, hi_i = sorted((b, a))
        else:
            lo_i, hi_i = sorted((b, c))
        if _test_interval(lo_i, hi_i, epsabs, epsrel):
            return root
    return root


def _bracket_fit(
    k_freq: np.ndarray, n_lower: float, n_upper: float
) -> Tuple[float, float]:
    """Bracket stage: Brent on d(profile LL)/dn over [n_lower, n_upper].

    If the derivative has the same sign at both endpoints, the endpoint with
    the larger profile log-likelihood is chosen (negbinom.cpp:188-200).
    Returns (p, n).
    """
    f = lambda n: _deriv1(n, k_freq)
    d_lo = f(n_lower)
    d_hi = f(n_upper)
    if (d_lo >= 0) == (d_hi >= 0):
        ll_lo = _profile_loglike(n_lower, k_freq)
        ll_hi = _profile_loglike(n_upper, k_freq)
        n = n_lower if ll_lo > ll_hi else n_upper
    else:
        n = _brent(f, n_lower, n_upper, BRACKET_MAX_ITER, BRACKET_ABS_ERR, BRACKET_REL_ERR)
    return optimal_success_prob(n, k_freq), n


def _gradient_fit(k_freq: np.ndarray, n_start: float) -> Tuple[float, float]:
    """Newton polish from n_start, keeping the reference's stopping rules:
    relative-delta 1e-4 convergence, runaway abort when n exceeds the
    support size (the runaway iterate is kept, negbinom.cpp:293-314).
    """
    n = n_start
    for _ in range(POLISH_MAX_ITER):
        n_last = n
        df = _deriv2(n, k_freq)
        if df == 0 or not math.isfinite(df):
            break
        n = n - _deriv1(n, k_freq) / df
        if abs(n - n_last) < POLISH_ABS_ERR + POLISH_REL_ERR * abs(n):
            break
        if n > len(k_freq):
            break  # runaway; keep the iterate like the reference does
    return optimal_success_prob(n, k_freq), n


def fit_negative_binomial(k_freq: np.ndarray) -> Tuple[float, float]:
    """Full 3-stage ML fit; returns (p_success, n_success).

    Mirrors fitNegativeBinomial (negbinom.cpp:112-129): moments ->
    bracketed Brent (bounds [max(1,n/2), min(range-1, 2n)] when the moment
    fit succeeded, else [1, range-1]) -> Newton polish.
    """
    k_freq = np.asarray(k_freq, dtype=np.float64)
    count, mean, variance = _moments(k_freq)
    if count <= 0:
        return float("nan"), float("nan")
    if variance > 0 and variance > mean:
        p = mean / variance
        n = mean * p / (1.0 - p)
        p, n = _bracket_fit(k_freq, max(1.0, n / 2.0), min(len(k_freq) - 1.0, n * 2.0))
    else:
        p, n = _bracket_fit(k_freq, 1.0, max(1.0, len(k_freq) - 1.0))
    return _gradient_fit(k_freq, n)
