"""HMM kernel tests: forward/backward/viterbi vs the NumPy oracle,
fw-vs-bw likelihood identity, chromosome-break handling, quirk semantics."""

import numpy as np
import jax.numpy as jnp
import pytest

import oracle
from ngsf_hmm.models.hmm import (
    forward,
    forward_loglik,
    loglik_value_and_grad,
    backward,
    posteriors,
    viterbi,
)

RNG = np.random.default_rng(42)


@pytest.fixture(scope="module")
def case():
    return oracle.random_case(RNG, S=61, N=5, chrom_break_every=17)


def _j(x):
    return jnp.asarray(x)


def test_forward_matches_oracle(case):
    gl, freq, dist, F, alpha, e = case
    fw, ll = forward(_j(e), _j(dist), _j(F), _j(alpha))
    fw, ll = np.asarray(fw), np.asarray(ll)
    for i in range(len(F)):
        fw_o, ll_o = oracle.forward(e[:, i], dist, F[i], alpha[i])
        np.testing.assert_allclose(fw[:, i], fw_o, rtol=0, atol=1e-12)
        assert ll[i] == pytest.approx(ll_o, abs=1e-12)


def test_forward_loglik_matches_forward(case):
    gl, freq, dist, F, alpha, e = case
    _, ll = forward(_j(e), _j(dist), _j(F), _j(alpha))
    ll2 = forward_loglik(_j(F), _j(alpha), _j(e), _j(dist))
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll2), rtol=1e-14)


def test_backward_matches_oracle(case):
    gl, freq, dist, F, alpha, e = case
    bw, ll = backward(_j(e), _j(dist), _j(F), _j(alpha))
    bw, ll = np.asarray(bw), np.asarray(ll)
    for i in range(len(F)):
        bw_o, ll_o = oracle.backward(e[:, i], dist, F[i], alpha[i])
        np.testing.assert_allclose(bw[:, i], bw_o, rtol=0, atol=1e-12)
        assert ll[i] == pytest.approx(ll_o, abs=1e-12)


def test_fw_bw_likelihood_identity(case):
    """The reference asserts |fw_lkl - bw_lkl| <= 0.001 at runtime
    (EM.cpp:166-170); in float64 we hold a much tighter tolerance."""
    gl, freq, dist, F, alpha, e = case
    p1, ll_f, ll_b = posteriors(_j(e), _j(dist), _j(F), _j(alpha))
    np.testing.assert_allclose(np.asarray(ll_f), np.asarray(ll_b), atol=1e-9)
    p1 = np.asarray(p1)
    assert np.all(p1 >= -1e-12) and np.all(p1 <= 1 + 1e-12)


def test_posterior_matches_oracle(case):
    gl, freq, dist, F, alpha, e = case
    p1, ll_f, _ = posteriors(_j(e), _j(dist), _j(F), _j(alpha))
    p1 = np.asarray(p1)
    for i in range(len(F)):
        fw_o, ll_o = oracle.forward(e[:, i], dist, F[i], alpha[i])
        bw_o, _ = oracle.backward(e[:, i], dist, F[i], alpha[i])
        want = np.exp(fw_o[:, 1] + bw_o[:, 1] - ll_o)
        np.testing.assert_allclose(p1[:, i], want, atol=1e-12)


@pytest.mark.parametrize("compat", [True, False])
def test_viterbi_matches_oracle(case, compat):
    gl, freq, dist, F, alpha, e = case
    path, score = viterbi(_j(e), _j(dist), _j(F), _j(alpha), compat=compat)
    path, score = np.asarray(path), np.asarray(score)
    for i in range(len(F)):
        p_o, s_o = oracle.viterbi(e[:, i], dist, F[i], alpha[i], compat=compat)
        np.testing.assert_array_equal(path[:, i], p_o)
        assert score[i] == pytest.approx(s_o, abs=1e-12)


def test_viterbi_compat_quirk_can_differ():
    """Construct a case where the in-place update changes the decision,
    to show compat mode is really exercising the quirk (SURVEY.md §3.6a)."""
    rng = np.random.default_rng(3)
    diffs = 0
    for _ in range(30):
        gl, freq, dist, F, alpha, e = oracle.random_case(rng, S=40, N=3)
        p_c, _ = viterbi(_j(e), _j(dist), _j(F), _j(alpha), compat=True)
        p_t, _ = viterbi(_j(e), _j(dist), _j(F), _j(alpha), compat=False)
        diffs += int(not np.array_equal(np.asarray(p_c), np.asarray(p_t)))
    assert diffs > 0, "quirk never changed a path; compat flag untested"


def test_single_site():
    gl, freq, dist, F, alpha, e = oracle.random_case(RNG, S=1, N=2)
    fw, ll = forward(_j(e), _j(dist), _j(F), _j(alpha))
    bw, ll_b = backward(_j(e), _j(dist), _j(F), _j(alpha))
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_b), atol=1e-12)
    path, _ = viterbi(_j(e), _j(dist), _j(F), _j(alpha))
    assert path.shape == (1, 2)


def test_analytic_value_and_grad_matches_autodiff(case):
    """The Fisher-identity gradient (loglik_value_and_grad) must agree
    with reverse-mode autodiff through the scan -- including at
    chromosome-break (inf) distances, which the fixture contains."""
    import jax

    gl, freq, dist, F, alpha, e = case
    L, gF, ga = loglik_value_and_grad(_j(F), _j(alpha), _j(e), _j(dist))
    ll_ref = forward_loglik(_j(F), _j(alpha), _j(e), _j(dist))
    np.testing.assert_allclose(np.asarray(L), np.asarray(ll_ref), rtol=1e-14)

    f = lambda F_, a_: jnp.sum(forward_loglik(F_, a_, _j(e), _j(dist)))
    gF_ad, ga_ad = jax.grad(f, argnums=(0, 1))(_j(F), _j(alpha))
    np.testing.assert_allclose(np.asarray(gF), np.asarray(gF_ad), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(ga_ad), rtol=1e-9)


def test_analytic_grad_at_bound_params():
    """Near the box bounds the reference pins parameters (F ~ 1e-15,
    alpha ~ 10); the analytic gradient must stay finite there."""
    gl, freq, dist, F, alpha, e = oracle.random_case(RNG, S=30, N=4)
    F = np.array([1e-15, 1 - 1e-15, 0.5, 1e-6])
    alpha = np.array([1e-15, 10.0, 0.3, 9.9])
    L, gF, ga = loglik_value_and_grad(_j(F), _j(alpha), _j(e), _j(dist))
    assert np.all(np.isfinite(np.asarray(L)))
    assert np.all(np.isfinite(np.asarray(gF)))
    assert np.all(np.isfinite(np.asarray(ga)))


def test_grad_forward_loglik_finite(case):
    """Autodiff through the scan (the M-step gradient) is finite and
    matches central differences."""
    import jax

    gl, freq, dist, F, alpha, e = case
    f = lambda F_, a_: jnp.sum(forward_loglik(F_, a_, _j(e), _j(dist)))
    gF, ga = jax.grad(f, argnums=(0, 1))(_j(F), _j(alpha))
    assert np.all(np.isfinite(np.asarray(gF)))
    assert np.all(np.isfinite(np.asarray(ga)))
    eps = 1e-6
    for i in range(2):
        Fp = F.copy(); Fp[i] += eps
        Fm = F.copy(); Fm[i] -= eps
        num = (f(_j(Fp), _j(alpha)) - f(_j(Fm), _j(alpha))) / (2 * eps)
        assert np.asarray(gF)[i] == pytest.approx(float(num), rel=1e-4)
