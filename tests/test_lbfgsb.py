"""Batched box-constrained L-BFGS tests on problems with known optima."""

import numpy as np
import jax.numpy as jnp
import pytest

from ngsf_hmm.models.lbfgsb import lbfgsb_minimize


def test_batched_quadratics():
    # f_b(x) = sum_i c_bi (x_i - mu_bi)^2, optimum = clip(mu, l, u)
    rng = np.random.default_rng(0)
    B, n = 16, 2
    mu = rng.uniform(-2, 2, size=(B, n))
    c = rng.uniform(0.5, 4.0, size=(B, n))
    lower = np.full((B, n), -1.0)
    upper = np.full((B, n), 1.0)

    def fun(x):
        return jnp.sum(jnp.asarray(c) * (x - jnp.asarray(mu)) ** 2, axis=-1)

    x0 = jnp.zeros((B, n))
    x, f, it = lbfgsb_minimize(fun, x0, jnp.asarray(lower), jnp.asarray(upper))
    want = np.clip(mu, lower, upper)
    np.testing.assert_allclose(np.asarray(x), want, atol=2e-3)


def test_rosenbrock_in_box():
    B = 8
    lower = jnp.tile(jnp.array([[-2.0, -2.0]]), (B, 1))
    upper = jnp.tile(jnp.array([[2.0, 2.0]]), (B, 1))

    def fun(x):
        a, b = x[:, 0], x[:, 1]
        return (1 - a) ** 2 + 100 * (b - a**2) ** 2

    rng = np.random.default_rng(1)
    x0 = jnp.asarray(rng.uniform(-1.5, 1.5, size=(B, 2)))
    x, f, it = lbfgsb_minimize(fun, x0, lower, upper, max_iters=300)
    np.testing.assert_allclose(np.asarray(x), np.ones((B, 2)), atol=5e-3)


def test_pinned_coordinates():
    # lower == upper pins a coordinate exactly (the fixed-F/fixed-alpha path,
    # EM.cpp:429-436)
    B = 4

    def fun(x):
        return jnp.sum((x - 3.0) ** 2, axis=-1)

    x0 = jnp.full((B, 2), 0.7)
    lower = jnp.stack([jnp.full((B,), 0.7), jnp.full((B,), -10.0)], axis=-1)
    upper = jnp.stack([jnp.full((B,), 0.7), jnp.full((B,), 10.0)], axis=-1)
    x, f, it = lbfgsb_minimize(fun, x0, lower, upper)
    np.testing.assert_allclose(np.asarray(x[:, 0]), 0.7, atol=0)
    np.testing.assert_allclose(np.asarray(x[:, 1]), 3.0, atol=1e-3)


def test_warm_start_cuts_iterations():
    """Re-solving a slightly-perturbed problem from the previous solve's
    curvature memory (the EM warm start) must converge to the same
    optimum in fewer outer iterations than a cold start."""
    rng = np.random.default_rng(7)
    B, n = 32, 2
    mu = rng.uniform(-2, 2, size=(B, n))
    c = rng.uniform(0.5, 4.0, size=(B, n))
    lower = jnp.full((B, n), -10.0)
    upper = jnp.full((B, n), 10.0)

    def make_fun(mu_):
        mu_j = jnp.asarray(mu_)
        c_j = jnp.asarray(c)

        def fun(x):
            # anisotropic + cross-term so the Hessian is non-trivial
            d = x - mu_j
            return jnp.sum(c_j * d**2, -1) + 0.3 * d[:, 0] * d[:, 1]

        return fun

    x0 = jnp.zeros((B, n))
    x1, _, it1, mem = lbfgsb_minimize(
        make_fun(mu), x0, lower, upper, return_memory=True
    )
    mu2 = mu + rng.normal(0, 0.01, mu.shape)  # the "next EM iteration"
    xw, _, itw = lbfgsb_minimize(make_fun(mu2), x1, lower, upper, warm=mem)
    xc, _, itc = lbfgsb_minimize(make_fun(mu2), x1, lower, upper)
    np.testing.assert_allclose(np.asarray(xw), np.asarray(xc), atol=2e-3)
    assert int(itw) <= int(itc)
    assert int(itw) <= 3  # warm solve is a handful of probes


def test_warm_start_em_trajectory_matches_cold():
    """run_em with the warm-started M-step (default) reaches the same
    optimizer endpoints as the cold-started loop within PGTOL-bounded
    tolerances -- the guarantee the golden gates rely on."""
    import oracle
    from ngsf_hmm.models.em import EMOptions, init_state, run_em

    rng = np.random.default_rng(9)
    gl, freq, dist, F, alpha, e = oracle.random_case(rng, S=200, N=6)
    gl_j = jnp.asarray(np.transpose(gl, (1, 0, 2)))
    d_j = jnp.asarray(dist)
    st0 = init_state(gl_j, jnp.asarray(freq), jnp.asarray(F),
                     jnp.asarray(alpha))
    base = dict(min_iters=3, max_iters=6, min_epsilon=1e-12)
    warm = run_em(gl_j, d_j, st0, EMOptions(warm_mstep=True, **base))
    cold = run_em(gl_j, d_j, st0, EMOptions(warm_mstep=False, **base))
    # mid-trajectory totals wiggle at the PGTOL-bounded endpoint level
    # (~1e-5 relative here); the golden gates run at 1e-4
    assert warm.tot_lkl == pytest.approx(cold.tot_lkl, rel=1e-4)
    np.testing.assert_allclose(
        np.asarray(warm.state.indF), np.asarray(cold.state.indF), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(warm.state.freq), np.asarray(cold.state.freq), atol=5e-4
    )


def test_cold_start_escapes_corner_trap():
    """A cold steepest-descent step projected into a box corner passes
    Armijo but can be a local trap; the breakpoint logic must probe the
    interior of the projected path and keep the better point (the
    batched stand-in for L-BFGS-B's generalized Cauchy point). Surface:
    a deep interior valley at small y, plus a corner that is better
    than the start but worse than the valley."""

    def fun(x):
        a, b = x[:, 0], x[:, 1]
        # gradient at the start pushes b hard toward its lower bound
        # and a toward its upper; the (a=1, b=0) corner improves on the
        # start but the true optimum is interior: (0.6, 0.05)
        return 100.0 * (b - 0.05) ** 2 + 40.0 * (a - 0.6) ** 2

    B = 3
    x0 = jnp.tile(jnp.array([[0.1, 0.9]]), (B, 1))
    lower = jnp.zeros((B, 2))
    upper = jnp.tile(jnp.array([[1.0, 1.0]]), (B, 1))
    x, f, it = lbfgsb_minimize(fun, x0, lower, upper)
    np.testing.assert_allclose(
        np.asarray(x), np.tile([[0.6, 0.05]], (B, 1)), atol=1e-3
    )


def test_cold_start_interior_below_breakpoint():
    """The Armijo point can sit BELOW the first bound breakpoint of the
    projected path (the 10x10k cold-start geometry): a plain 0.1-0.5x
    decay ladder needs ~12 rounds to reach it and a capped ladder
    freezes the row at its start; the breakpoint snap must land it."""

    def fun(x):
        a, b = x[:, 0], x[:, 1]
        # steep wall right at b's lower bound, optimum just inside it;
        # |grad_b| at the start is ~400 like the measured HMM case
        return 2000.0 * (b - 0.01) ** 2 + 0.5 * (a - 0.5) ** 2

    B = 2
    x0 = jnp.tile(jnp.array([[0.1, 0.2]]), (B, 1))
    lower = jnp.full((B, 2), 1e-15)
    upper = jnp.tile(jnp.array([[1.0, 10.0]]), (B, 1))
    x, f, it = lbfgsb_minimize(fun, x0, lower, upper)
    assert np.all(np.asarray(x)[:, 1] > 1e-3), "row froze at its start"
    np.testing.assert_allclose(
        np.asarray(x), np.tile([[0.5, 0.01]], (B, 1)), atol=1e-3
    )


def test_bound_seeking_rows_still_reach_bounds():
    """Rows whose optimum IS on a bound must still get there (the
    breakpoint logic must not wall off the boundary): minimise a
    monotone objective pushing both coordinates to opposite bounds."""

    def fun(x):
        return 3.0 * x[:, 0] - 2.0 * x[:, 1]

    B = 2
    x0 = jnp.tile(jnp.array([[0.5, 0.5]]), (B, 1))
    lower = jnp.zeros((B, 2))
    upper = jnp.ones((B, 2))
    x, f, it = lbfgsb_minimize(fun, x0, lower, upper)
    np.testing.assert_allclose(
        np.asarray(x), np.tile([[0.0, 1.0]], (B, 1)), atol=1e-6
    )


def test_hmm_objective_improves_loglik():
    """Optimising (F, alpha) on the real forward-likelihood objective
    increases the likelihood and stays inside the reference bounds."""
    import oracle
    from ngsf_hmm.models.hmm import forward_loglik
    from ngsf_hmm.utils.constants import F_MIN, F_MAX, ALPHA_MIN, ALPHA_MAX

    rng = np.random.default_rng(5)
    gl, freq, dist, F, alpha, e = oracle.random_case(rng, S=120, N=6)
    e_j, d_j = jnp.asarray(e), jnp.asarray(dist)

    def fun(x):
        return -forward_loglik(x[:, 0], x[:, 1], e_j, d_j)

    x0 = jnp.stack([jnp.asarray(F), jnp.asarray(alpha)], axis=-1)
    lower = jnp.tile(jnp.array([[F_MIN, ALPHA_MIN]]), (6, 1))
    upper = jnp.tile(jnp.array([[F_MAX, ALPHA_MAX]]), (6, 1))
    x, f, it = lbfgsb_minimize(fun, x0, lower, upper)
    f0 = fun(x0)
    assert np.all(np.asarray(f) <= np.asarray(f0) + 1e-9)
    assert np.all(np.asarray(x) >= np.asarray(lower))
    assert np.all(np.asarray(x) <= np.asarray(upper))
