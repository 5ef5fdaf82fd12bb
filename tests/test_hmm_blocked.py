"""Blocked (depth-O(sqrt S)) kernels vs the sequential scan kernels.

The blocked kernels re-associate the site recursion and max-normalise
all carries, so:
 - float64 results match the sequential kernels to ~1e-10 on every
   observable (loglik, posteriors, gradients), across odd sizes
   (padding), block sizes 1 / S / larger-than-S, and chromosome-break
   (inf) distances;
 - float32 results stay accurate even when |loglik| ~ 1e5 (the case
   that breaks a naive blocked formulation: posteriors would be garbage
   without the normalisation strategy in hmm_blocked.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

import oracle
from ngsf_hmm.models.hmm import (
    forward_loglik,
    loglik_value_and_grad,
    posteriors,
)
from ngsf_hmm.models.hmm_blocked import (
    block_sites,
    forward_loglik_blocked,
    forward_loglik_blocked_lin,
    loglik_value_and_grad_blocked,
    loglik_value_and_grad_blocked_lin,
    pick_block_size,
    posteriors_blocked,
    posteriors_blocked_lin,
    unblock_sites,
)

RNG = np.random.default_rng(7)


def _blk(e, dist, bs, dtype=None):
    e = jnp.asarray(e) if dtype is None else jnp.asarray(e, dtype)
    dist = jnp.asarray(dist) if dtype is None else jnp.asarray(dist, dtype)
    e_blk, S = block_sites(e, bs, 0.0)
    d_blk, _ = block_sites(dist, bs, 0.0)
    return e_blk, d_blk, S


@pytest.mark.parametrize("S,bs", [(61, 8), (64, 8), (61, 61), (61, 128), (7, 3), (1, 8)])
def test_blocked_loglik_matches_sequential(S, bs):
    gl, freq, dist, F, alpha, e = oracle.random_case(RNG, S=S, N=4, chrom_break_every=17)
    e_blk, d_blk, S_ = _blk(e, dist, bs)
    ll_b = forward_loglik_blocked(jnp.asarray(F), jnp.asarray(alpha), e_blk, d_blk)
    ll_s = forward_loglik(jnp.asarray(F), jnp.asarray(alpha), jnp.asarray(e), jnp.asarray(dist))
    np.testing.assert_allclose(np.asarray(ll_b), np.asarray(ll_s), rtol=1e-12)


@pytest.mark.parametrize("S,bs", [(61, 8), (101, 16), (23, 5)])
def test_blocked_posteriors_match(S, bs):
    gl, freq, dist, F, alpha, e = oracle.random_case(RNG, S=S, N=5, chrom_break_every=29)
    jF, ja, je, jd = map(jnp.asarray, (F, alpha, e, dist))
    e_blk, d_blk, S_ = _blk(e, dist, bs)
    p_b, llf_b, llb_b = posteriors_blocked(e_blk, d_blk, jF, ja, S_)
    p_s, llf_s, llb_s = posteriors(je, jd, jF, ja)
    np.testing.assert_allclose(np.asarray(p_b), np.asarray(p_s), atol=1e-10)
    np.testing.assert_allclose(np.asarray(llf_b), np.asarray(llf_s), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(llb_b), np.asarray(llb_s), rtol=1e-12)


def test_blocked_value_and_grad_matches():
    gl, freq, dist, F, alpha, e = oracle.random_case(RNG, S=77, N=4, chrom_break_every=19)
    jF, ja, je, jd = map(jnp.asarray, (F, alpha, e, dist))
    e_blk, d_blk, _ = _blk(e, dist, 9)
    L_b, gF_b, ga_b = loglik_value_and_grad_blocked(jF, ja, e_blk, d_blk)
    L_s, gF_s, ga_s = loglik_value_and_grad(jF, ja, je, jd)
    np.testing.assert_allclose(np.asarray(L_b), np.asarray(L_s), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(gF_b), np.asarray(gF_s), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(ga_b), np.asarray(ga_s), rtol=1e-9)


def test_blocked_float32_large_magnitude():
    """At 40k sites |loglik| ~ 5e4 -- float32 absolute resolution ~4e-3.
    The normalised blocked kernels must still deliver accurate posteriors
    and gradients (validated against the float64 sequential kernels)."""
    S, N, bs = 40_000, 4, 164
    gl, freq, dist, F, alpha, e = oracle.random_case(RNG, S=S, N=N, chrom_break_every=9973)
    jF, ja, je, jd = map(jnp.asarray, (F, alpha, e, dist))

    p64, llf64, _ = posteriors(je, jd, jF, ja)
    L64, gF64, ga64 = loglik_value_and_grad(jF, ja, je, jd)
    assert float(jnp.abs(llf64).max()) > 2e4  # magnitude really is large

    e32, d32, S_ = _blk(e, dist, bs, dtype=jnp.float32)
    F32, a32 = jnp.asarray(F, jnp.float32), jnp.asarray(alpha, jnp.float32)
    p32, llf32, llb32 = posteriors_blocked(e32, d32, F32, a32, S_)
    np.testing.assert_allclose(np.asarray(p32), np.asarray(p64), atol=2e-3)
    np.testing.assert_allclose(np.asarray(llf32), np.asarray(llf64), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(llb32), np.asarray(llf64), rtol=1e-5)

    L32, gF32, ga32 = loglik_value_and_grad_blocked(F32, a32, e32, d32)
    np.testing.assert_allclose(np.asarray(L32), np.asarray(L64), rtol=1e-5)
    # gradients are O(S)-magnitude sums; demand ~3 significant digits
    np.testing.assert_allclose(np.asarray(gF32), np.asarray(gF64), rtol=5e-3)
    np.testing.assert_allclose(np.asarray(ga32), np.asarray(ga64), rtol=5e-3)


def _blk_lin(e, dist, bs, dtype=None):
    """Linear-space blocked emissions (pad value 1 = identity)."""
    e_lin = np.exp(e)
    e_lin = jnp.asarray(e_lin) if dtype is None else jnp.asarray(e_lin, dtype)
    dist = jnp.asarray(dist) if dtype is None else jnp.asarray(dist, dtype)
    e_blk, S = block_sites(e_lin, bs, 1.0)
    d_blk, _ = block_sites(dist, bs, 0.0)
    return e_blk, d_blk, S


@pytest.mark.parametrize("S,bs", [(61, 8), (101, 16), (7, 3)])
def test_linear_kernels_match_log(S, bs):
    """Linear scaled kernels == log-semiring kernels (f64, ~1e-10)."""
    gl, freq, dist, F, alpha, e = oracle.random_case(RNG, S=S, N=4, chrom_break_every=23)
    jF, ja = jnp.asarray(F), jnp.asarray(alpha)
    el_blk, d_blk, S_ = _blk_lin(e, dist, bs)

    ll_lin = forward_loglik_blocked_lin(jF, ja, el_blk, d_blk)
    ll_log = forward_loglik(jF, ja, jnp.asarray(e), jnp.asarray(dist))
    np.testing.assert_allclose(np.asarray(ll_lin), np.asarray(ll_log), rtol=1e-12)

    p_lin, llf, llb = posteriors_blocked_lin(el_blk, d_blk, jF, ja, S_)
    p_log, llf_s, _ = posteriors(jnp.asarray(e), jnp.asarray(dist), jF, ja)
    np.testing.assert_allclose(np.asarray(p_lin), np.asarray(p_log), atol=1e-10)
    np.testing.assert_allclose(np.asarray(llf), np.asarray(llf_s), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(llb), np.asarray(llf_s), rtol=1e-12)

    L_l, gF_l, ga_l = loglik_value_and_grad_blocked_lin(jF, ja, el_blk, d_blk)
    L_s, gF_s, ga_s = loglik_value_and_grad(jF, ja, jnp.asarray(e), jnp.asarray(dist))
    np.testing.assert_allclose(np.asarray(L_l), np.asarray(L_s), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(gF_l), np.asarray(gF_s), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(ga_l), np.asarray(ga_s), rtol=1e-9)


def test_linear_float32_large_magnitude():
    """Linear scaled kernels keep f32 accuracy at |loglik| ~ 5e4."""
    S, N, bs = 40_000, 4, 164
    gl, freq, dist, F, alpha, e = oracle.random_case(RNG, S=S, N=N, chrom_break_every=9973)
    p64, llf64, _ = posteriors(jnp.asarray(e), jnp.asarray(dist), jnp.asarray(F), jnp.asarray(alpha))
    L64, gF64, ga64 = loglik_value_and_grad(
        jnp.asarray(F), jnp.asarray(alpha), jnp.asarray(e), jnp.asarray(dist)
    )
    el32, d32, S_ = _blk_lin(e, dist, bs, dtype=jnp.float32)
    F32, a32 = jnp.asarray(F, jnp.float32), jnp.asarray(alpha, jnp.float32)
    p32, llf32, llb32 = posteriors_blocked_lin(el32, d32, F32, a32, S_)
    np.testing.assert_allclose(np.asarray(p32), np.asarray(p64), atol=2e-3)
    np.testing.assert_allclose(np.asarray(llf32), np.asarray(llf64), rtol=1e-5)
    L32, gF32, ga32 = loglik_value_and_grad_blocked_lin(F32, a32, el32, d32)
    np.testing.assert_allclose(np.asarray(L32), np.asarray(L64), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gF32), np.asarray(gF64), rtol=5e-3)
    np.testing.assert_allclose(np.asarray(ga32), np.asarray(ga64), rtol=5e-3)


def test_linear_em_iteration_matches_log():
    """Full EM iterations in linear mode track the f64 log-mode trajectory."""
    from ngsf_hmm.models.em import em_iteration, init_state

    S, N = 500, 5
    gl, freq, dist, F, alpha, e = oracle.random_case(RNG, S=S, N=N)
    gl_j = jnp.asarray(np.transpose(gl, (1, 0, 2)))  # ind-major -> site-major
    dist_j = jnp.asarray(dist)
    st_log = init_state(gl_j, jnp.asarray(freq), jnp.asarray(F), jnp.asarray(alpha))
    st_lin = st_log
    for _ in range(3):
        st_log, _ = em_iteration(gl_j, dist_j, st_log, block_size=16)
        st_lin, _ = em_iteration(
            gl_j, dist_j, st_lin, block_size=16, numerics="linear"
        )
    np.testing.assert_allclose(
        np.asarray(st_lin.freq), np.asarray(st_log.freq), atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(st_lin.indF), np.asarray(st_log.indF), atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(st_lin.ind_lkl), np.asarray(st_log.ind_lkl), rtol=1e-10
    )


def test_pick_block_size():
    assert pick_block_size(100_000) == pytest.approx(258, abs=10)
    assert pick_block_size(1) >= 1
    assert pick_block_size(10) >= 2


def test_block_roundtrip():
    x = np.arange(23 * 3, dtype=float).reshape(23, 3)
    xb, S = block_sites(jnp.asarray(x), 5, 0.0)
    assert xb.shape == (5, 5, 3)
    np.testing.assert_array_equal(np.asarray(unblock_sites(xb, S)), x)
