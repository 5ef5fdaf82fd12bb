"""Unit coverage for the --opt compat engine's exact-order kernels.

The strong gate is golden byte-parity (test_golden.py::
test_golden_compat_byte_identical, vs the built reference binary);
these tests pin the compat kernels against the jnp tiers at
analytic-agreement tolerances so the engine has coverage even where
the binary is unavailable, and lock the glibc-vs-vectorised-exp
distinction that byte parity rests on.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import oracle
from ngsf_hmm.io import native
from ngsf_hmm.models import em_compat as ec
from ngsf_hmm.models.em import EMOptions, init_state
from ngsf_hmm.models.hmm import forward_loglik, posteriors
from ngsf_hmm.ops.emissions import calc_emission
from ngsf_hmm.ops.maf import est_maf

RNG = np.random.default_rng(99)


def _case(S=200, N=5, br=61):
    gl, freq, dist, F, alpha, e = oracle.random_case(
        RNG, S=S, N=N, chrom_break_every=br
    )
    return np.transpose(gl, (1, 0, 2)), freq, dist, F, alpha


def test_vexp_vlog_match_glibc():
    import math

    x = RNG.uniform(-30, 3, size=257)
    np.testing.assert_array_equal(
        native.vexp(x), np.array([math.exp(v) for v in x])
    )
    y = np.abs(x) + 1e-3
    np.testing.assert_array_equal(
        native.vlog(y), np.array([math.log(v) for v in y])
    )
    assert native.vlog(np.array([0.0]))[0] == -np.inf


def test_calc_emission_ref_matches_jnp_tier():
    gl, freq, dist, F, alpha = _case()
    want = np.asarray(calc_emission(jnp.asarray(gl), jnp.asarray(freq)[:, None]))
    got = ec.calc_emission_ref(gl, freq[:, None])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_forward_backward_ref_match_jnp_tier():
    gl, freq, dist, F, alpha = _case()
    e = ec.calc_emission_ref(gl, freq[:, None])
    ll = ec.forward_ref(e, dist, F, alpha)
    want = np.asarray(forward_loglik(
        jnp.asarray(F), jnp.asarray(alpha), jnp.asarray(e), jnp.asarray(dist)
    ))
    np.testing.assert_allclose(ll, want, rtol=1e-12)
    p, ll_f, ll_b = ec.posteriors_ref(e, dist, F, alpha)
    np.testing.assert_allclose(ll_f, ll_b, atol=1e-9)
    p_want, _, _ = posteriors(
        jnp.asarray(e), jnp.asarray(dist), jnp.asarray(F), jnp.asarray(alpha)
    )
    np.testing.assert_allclose(p, np.asarray(p_want), atol=1e-10)


def test_est_maf_ref_matches_exact_damped():
    gl, freq, dist, F, alpha = _case()
    p_ibd = RNG.random((gl.shape[0], gl.shape[1]))
    got = ec.est_maf_ref(gl, p_ibd)
    want = np.asarray(est_maf(jnp.asarray(gl), jnp.asarray(p_ibd)))
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_viterbi_ref_matches_compat_jnp():
    from ngsf_hmm.models.hmm import viterbi

    gl, freq, dist, F, alpha = _case()
    e = ec.calc_emission_ref(gl, freq[:, None])
    got = ec.viterbi_ref(e, dist, F, alpha)
    want, _ = viterbi(
        jnp.asarray(e), jnp.asarray(dist), jnp.asarray(F),
        jnp.asarray(alpha), compat=True,
    )
    np.testing.assert_array_equal(got, np.asarray(want))


def test_run_em_compat_tracks_speed_engine():
    """Converged endpoints agree with the default engine within the
    optimizer-endpoint tolerances that separate the two designs."""
    from ngsf_hmm.models.em import run_em

    # own RNG: endpoint-tolerance gates are draw-sensitive and the
    # module RNG's state depends on test order
    rng = np.random.default_rng(512)
    gl, freq, dist, F, alpha, _ = oracle.random_case(
        rng, S=150, N=4, chrom_break_every=47
    )
    gl = np.transpose(gl, (1, 0, 2))
    gl_j = jnp.asarray(gl)
    dist_j = jnp.asarray(dist)
    st0 = init_state(gl_j, jnp.asarray(freq), jnp.asarray(F),
                     jnp.asarray(alpha))
    opts = EMOptions(min_iters=3, max_iters=8, min_epsilon=1e-4, verbose=0)
    a = run_em(gl_j, dist_j, st0, opts)
    b = ec.run_em_compat(gl_j, dist_j, st0, opts)
    assert b.tot_lkl == pytest.approx(a.tot_lkl, rel=1e-4)
    np.testing.assert_allclose(
        np.asarray(b.state.indF), np.asarray(a.state.indF), atol=3e-3
    )
    np.testing.assert_allclose(
        np.asarray(b.state.freq), np.asarray(a.state.freq), atol=1e-3
    )


def test_run_em_compat_rejects_ld_paths():
    gl, freq, dist, F, alpha = _case(S=50, N=3, br=0)
    st0 = init_state(jnp.asarray(gl), jnp.asarray(freq), jnp.asarray(F),
                     jnp.asarray(alpha))
    with pytest.raises(NotImplementedError):
        ec.run_em_compat(jnp.asarray(gl), jnp.asarray(dist), st0,
                         EMOptions(freq_est=2))
