"""The Triton tier inside the EM engine: full iterations, run_em's
deferred state fields, and the one place that picks the chain tier.

Kernels run in the Pallas interpreter on the CPU (the same kernel code
the GPU compiles through Triton); f32 tolerances as in the
blocked-linear tests."""

import numpy as np
import jax.numpy as jnp
import pytest

import oracle
from ngsf_hmm.models.em import resolve_numerics


@pytest.mark.parametrize("kw,tier", [
    (dict(), "pallas"),
    (dict(freq_est=0), "pallas"),
    (dict(e_prob_calc=2), "linear"),
    (dict(freq_est=2), "linear"),
    (dict(replicates=True), "linear"),
    (dict(site_mesh=True), "linear"),
    (dict(mesh_stream=True), "linear"),
])
def test_resolve_numerics_routes(kw, tier):
    """--kernel pallas keeps the Triton tier only where the GL-fused
    kernels apply; LD emissions, replicates, site meshes and mesh
    streams take the XLA blocked-linear tier, with a note saying so."""
    got, note = resolve_numerics("pallas", **kw)
    assert got == tier
    assert ("Triton GL-fused" in note) == (tier == "pallas")
    assert ("blocked-linear" in note) == (tier == "linear")


@pytest.mark.parametrize("numerics", ["log", "linear"])
def test_resolve_numerics_leaves_xla_tiers(numerics):
    assert resolve_numerics(numerics, e_prob_calc=2, replicates=True,
                            site_mesh=True) == (numerics, None)


def test_pallas_em_iteration_matches_log():
    """Full EM iterations in pallas mode track the f64 log-mode
    trajectory (f32 kernel tolerances)."""
    from ngsf_hmm.models.em import em_iteration, init_state

    # Own RNG: the module-level RNG's state depends on which tests ran
    # before, and this test's tolerances are trajectory- (not kernel-)
    # limited, so the draw must be reproducible in isolation.
    rng = np.random.default_rng(400)
    S, N = 400, 5
    gl, freq, dist, F, alpha, e = oracle.random_case(rng, S=S, N=N,
                                                     chrom_break_every=113)
    gl_j = jnp.asarray(np.transpose(gl, (1, 0, 2)))
    dist_j = jnp.asarray(dist)
    st_log = init_state(gl_j, jnp.asarray(freq), jnp.asarray(F),
                        jnp.asarray(alpha))
    st_pal = st_log
    for _ in range(3):
        st_log, _ = em_iteration(gl_j, dist_j, st_log, block_size=16)
        st_pal, stats = em_iteration(
            gl_j, dist_j, st_pal, numerics="pallas"
        )
    # freq inherits the optimizer-endpoint drift through the posteriors
    # (same PGTOL-bounded divergence as indF below), so its agreement is
    # also trajectory- not kernel-limited after 3 iterations
    np.testing.assert_allclose(
        np.asarray(st_pal.freq), np.asarray(st_log.freq), atol=1e-3
    )
    # indF agreement is bounded by the OPTIMIZER stop tolerance
    # (PGTOL = 1e-3), not kernel accuracy: both modes stop within pgtol
    # of the same flat optimum, so tiny f32 rounding differences between
    # kernel tiers can move the endpoint by O(pgtol). Kernel accuracy
    # itself is pinned at rtol 2e-6 by the dedicated tests above.
    np.testing.assert_allclose(
        np.asarray(st_pal.indF), np.asarray(st_log.indF), atol=3e-3
    )
    # ind_lkl is evaluated AT the diverged endpoints: with indF apart by
    # O(pgtol) and |dll/dindF| up to O(10) near the optimum, ll can move
    # by ~1e-2 absolute (~2e-5 relative at ll ~ -400). 1e-4 keeps margin
    # while still catching any real kernel break (those show at >1e-2).
    np.testing.assert_allclose(
        np.asarray(st_pal.ind_lkl), np.asarray(st_log.ind_lkl), rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(st_pal.p_ibd), np.asarray(st_log.p_ibd), atol=5e-3
    )


def test_run_em_deferred_emissions_match_manual_loop():
    """run_em's fused-mode loop defers the per-iteration e_prob
    materialisation (write-only inside the loop) and rebuilds it at
    exit; the result must equal the undeferred iteration-by-iteration
    trajectory, and checkpoint callbacks must see a LIVE e_prob."""
    from ngsf_hmm.models.em import (
        EMOptions, em_iteration, init_state, run_em,
    )

    rng = np.random.default_rng(411)
    S, N = 300, 6
    gl, freq, dist, F, alpha, e = oracle.random_case(rng, S=S, N=N)
    gl_j = jnp.asarray(np.transpose(gl, (1, 0, 2)), jnp.float32)
    dist_j = jnp.asarray(dist, jnp.float32)
    st0 = init_state(gl_j, jnp.asarray(freq, jnp.float32),
                     jnp.asarray(F, jnp.float32),
                     jnp.asarray(alpha, jnp.float32))

    seen = {}

    def cb(n_iter, st, bkd):
        seen[n_iter] = np.asarray(st.e_prob)

    opts = EMOptions(numerics="pallas", min_iters=3, max_iters=3,
                     min_epsilon=1e-9)
    res = run_em(gl_j, dist_j, st0, opts, checkpoint_cb=cb)

    # mirror run_em's step exactly (slab threading + warm M-step
    # memory) minus the deferral
    st, slabs, mem = st0, None, None
    for _ in range(3):
        st, _, slabs, mem = em_iteration(
            gl_j, dist_j, st, numerics="pallas", prep_slabs=slabs,
            return_prep=True, opt_memory=mem, return_opt=True,
        )

    np.testing.assert_array_equal(np.asarray(res.state.freq),
                                  np.asarray(st.freq))
    np.testing.assert_array_equal(np.asarray(res.state.indF),
                                  np.asarray(st.indF))
    np.testing.assert_allclose(np.asarray(res.state.e_prob),
                               np.asarray(st.e_prob), rtol=2e-6)
    # the checkpointed e_prob at the last iteration is the live one
    np.testing.assert_allclose(seen[max(seen)],
                               np.asarray(res.state.e_prob), rtol=2e-6)


def test_run_em_deferred_posteriors_match_manual_loop():
    """With freq_est 0 run_em's fused loop ALSO defers the
    per-iteration [S, N] p_ibd unpack (nothing in the loop reads it) and
    rebuilds it at exit from the final iteration's PRE-update params;
    the result must equal the undeferred trajectory, and checkpoint
    callbacks must see a LIVE, snapped p_ibd."""
    from ngsf_hmm.models.em import (
        EMOptions, em_iteration, init_state, run_em,
    )

    rng = np.random.default_rng(413)
    S, N = 260, 40
    gl, freq, dist, F, alpha, e = oracle.random_case(rng, S=S, N=N)
    gl_j = jnp.asarray(np.transpose(gl, (1, 0, 2)), jnp.float32)
    dist_j = jnp.asarray(dist, jnp.float32)
    st0 = init_state(gl_j, jnp.asarray(freq, jnp.float32),
                     jnp.asarray(F, jnp.float32),
                     jnp.asarray(alpha, jnp.float32))

    seen = {}

    def cb(n_iter, st, bkd):
        seen[n_iter] = np.asarray(st.p_ibd)

    opts = EMOptions(numerics="pallas", freq_est=0, min_iters=3,
                     max_iters=3, min_epsilon=1e-9)
    res = run_em(gl_j, dist_j, st0, opts, checkpoint_cb=cb)

    # undeferred mirror
    st, slabs, mem = st0, None, None
    for _ in range(3):
        st, _, slabs, mem = em_iteration(
            gl_j, dist_j, st, freq_est=0, numerics="pallas",
            prep_slabs=slabs, return_prep=True, opt_memory=mem,
            return_opt=True,
        )

    np.testing.assert_array_equal(np.asarray(res.state.freq),
                                  np.asarray(st.freq))
    np.testing.assert_array_equal(np.asarray(res.state.indF),
                                  np.asarray(st.indF))
    # the rebuilt p_ibd re-runs the same kernels on the same threaded
    # slabs at the same params; XLA's fusion context (FMA formation)
    # differs between the standalone rebuild program and the fused
    # iteration, so agreement is to 1-2 f32 ulps, not bit-exact
    np.testing.assert_allclose(np.asarray(res.state.p_ibd),
                               np.asarray(st.p_ibd), atol=5e-7)
    np.testing.assert_array_equal(seen[max(seen)],
                                  np.asarray(res.state.p_ibd))
    # snapped (check_interv) values: anything within EPSILON of {0,1}
    # must be exactly 0/1
    p = np.asarray(res.state.p_ibd)
    assert not np.any((p > 0) & (p < 1e-5))
    assert not np.any((p < 1) & (p > 1 - 1e-5))
