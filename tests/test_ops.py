"""Unit tests for ops/: logsum, HWE, posteriors, emissions, transitions."""

import numpy as np
import jax.numpy as jnp
import pytest

import oracle
from ngsf_hmm.ops.logsum import logsum2, logsum3, logsum
from ngsf_hmm.ops.hwe import calc_hwe, post_prob, check_interv, call_geno, miss_data
from ngsf_hmm.ops.emissions import calc_emission, log_hwe_by_state, emission_probs_linear
from ngsf_hmm.ops.transitions import log_trans, trans, log_q

RNG = np.random.default_rng(7)


def test_logsum2_matches_oracle_ulp():
    a = RNG.normal(size=1000) * 50
    b = RNG.normal(size=1000) * 50
    got = np.asarray(logsum2(jnp.array(a), jnp.array(b)))
    want = np.array([oracle.logsum([x, y]) for x, y in zip(a, b)])
    np.testing.assert_allclose(got, want, rtol=1e-14)


def test_logsum2_neginf():
    assert np.asarray(logsum2(jnp.array(-jnp.inf), jnp.array(-jnp.inf))) == -np.inf
    assert np.isclose(np.asarray(logsum2(jnp.array(-jnp.inf), jnp.array(1.0))), 1.0)
    # -BIG stand-ins stay finite
    v = np.asarray(logsum2(jnp.array(-1e15), jnp.array(2.0)))
    assert v == 2.0


def test_logsum3_matches_oracle():
    a = RNG.normal(size=(500, 3)) * 30
    got = np.asarray(logsum3(jnp.array(a[:, 0]), jnp.array(a[:, 1]), jnp.array(a[:, 2])))
    want = np.array([oracle.logsum(r) for r in a])
    np.testing.assert_allclose(got, want, rtol=1e-14)


def test_logsum_axis():
    a = RNG.normal(size=(50, 4))
    got = np.asarray(logsum(jnp.array(a), axis=-1))
    want = np.array([oracle.logsum(r) for r in a])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("F", [0.0, 0.3, 1.0])
def test_calc_hwe(F):
    for maf in [0.0, 0.01, 0.25, 0.49]:
        got = np.asarray(calc_hwe(jnp.array(maf), jnp.array(F)))
        want = oracle.calc_hwe(maf, F)
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-15)
        got_lin = np.asarray(calc_hwe(jnp.array(maf), jnp.array(F), log_scale=False))
        want_lin = oracle.calc_hwe(maf, F, log_scale=False)
        np.testing.assert_array_equal(got_lin, want_lin)


def test_post_prob():
    gl = np.log(RNG.dirichlet(np.ones(3), size=20))
    prior = np.log(RNG.dirichlet(np.ones(3), size=20))
    got = np.asarray(post_prob(jnp.array(gl), jnp.array(prior)))
    want = np.array([oracle.post_prob(g, p) for g, p in zip(gl, prior)])
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-14)
    # linear-space posteriors sum to 1
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-12)


def test_check_interv():
    x = jnp.array([0.0, 1e-6, 2e-5, 0.5, 1 - 2e-5, 1 - 1e-6, 1.0])
    got = np.asarray(check_interv(x))
    np.testing.assert_array_equal(got, [0, 0, 2e-5, 0.5, 1 - 2e-5, 1, 1])


def test_call_geno():
    gl = np.log(np.array([[0.2, 0.5, 0.3], [1 / 3, 1 / 3, 1 / 3], [0.5, 0.2, 0.3]]))
    got = np.asarray(call_geno(jnp.array(gl)))
    assert got[0, 1] == 0.0 and got[0, 0] == -1e15 and got[0, 2] == -1e15
    np.testing.assert_allclose(got[1], np.log(1 / 3), rtol=1e-15)
    assert got[2, 0] == 0.0


def test_miss_data():
    gl = np.array([[0.1, 0.1, 0.1], [0.1, 0.2, 0.1], [0.1, 0.1 + 1e-6, 0.1]])
    got = np.asarray(miss_data(jnp.array(gl)))
    np.testing.assert_array_equal(got, [True, False, True])


def test_calc_emission_vs_oracle():
    gl = np.log(RNG.dirichlet(np.ones(3), size=(4, 6)))
    maf = RNG.uniform(0.01, 0.49, size=6)
    got = np.asarray(calc_emission(jnp.array(gl), jnp.array(maf)[None, :]))
    for i in range(4):
        for s in range(6):
            for k in range(2):
                want = oracle.calc_emission(gl[i, s], maf[s], k)
                assert got[i, s, k] == pytest.approx(want, abs=1e-14)


def test_emission_linear_matches_log():
    gl = np.log(RNG.dirichlet(np.ones(3), size=(4, 6)))
    maf = RNG.uniform(0.01, 0.49, size=6)
    e_log = np.asarray(calc_emission(jnp.array(gl), jnp.array(maf)[None, :]))
    e_lin = np.asarray(
        emission_probs_linear(jnp.array(np.exp(gl)), jnp.array(maf)[None, :])
    )
    np.testing.assert_allclose(np.exp(e_log), e_lin, rtol=1e-10)


def test_log_trans_vs_oracle():
    for d in [0.001, 0.5, 10.0, np.inf]:
        F, alpha = 0.37, 0.05
        got = np.asarray(log_trans(jnp.array([F]), jnp.array([alpha]), d))[0]
        q = [1 - F, F]
        for k in range(2):
            for l in range(2):
                want = oracle.log_trans(k, l, q[l], alpha, d)
                assert got[k, l] == pytest.approx(want, rel=1e-13), (k, l, d)


def test_trans_rows_sum_to_one():
    T = np.asarray(trans(jnp.array([0.3]), jnp.array([0.1]), 0.25))[0]
    np.testing.assert_allclose(T.sum(-1), 1.0, atol=1e-15)
    # infinite distance -> stationary rows
    Tinf = np.asarray(trans(jnp.array([0.3]), jnp.array([0.1]), np.inf))[0]
    np.testing.assert_allclose(Tinf, [[0.7, 0.3], [0.7, 0.3]], atol=0)


def test_log_q():
    got = np.asarray(log_q(jnp.array([0.25])))
    np.testing.assert_allclose(got, np.log([[0.75, 0.25]]), rtol=1e-15)
