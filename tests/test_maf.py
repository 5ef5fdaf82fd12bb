"""est_maf fixed point vs the per-site oracle (incl. accumulator quirk)."""

import numpy as np
import jax.numpy as jnp
import pytest

import oracle
from ngsf_hmm.ops.maf import est_maf


def test_est_maf_matches_oracle():
    rng = np.random.default_rng(11)
    S, N = 23, 9
    gl = np.log(rng.dirichlet(np.ones(3), size=(S, N)))
    indF = rng.uniform(0, 1, size=(S, N))
    # include snapped-to-1 posteriors (the F==1 HWE special case)
    indF[0, :] = 1.0
    indF[1, :] = 0.0
    got = np.asarray(est_maf(jnp.asarray(gl), jnp.asarray(indF)))
    want = np.array([oracle.est_maf(gl[s], indF[s]) for s in range(S)])
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_est_maf_uniform_prior():
    rng = np.random.default_rng(12)
    S, N = 5, 40
    # concentrated GLs around genotype counts drawn at known maf
    true_maf = 0.3
    geno = rng.binomial(2, true_maf, size=(S, N))
    gl = np.full((S, N, 3), np.log(0.01))
    for s in range(S):
        for i in range(N):
            gl[s, i, geno[s, i]] = np.log(0.98)
    gl -= np.log(np.exp(gl).sum(-1, keepdims=True))
    got = np.asarray(est_maf(jnp.asarray(gl), None))
    assert np.all(np.abs(got - geno.mean(axis=1) / 2) < 0.05)


def _realistic_gls(rng, S, N, depth_mean=2.0, err=0.01):
    """Poisson-depth binomial-error GLs (the simulator's model) --
    LINEAR space, normalised."""
    depth = rng.poisson(depth_mean, size=(S, N))
    tf = rng.uniform(0.05, 0.45, size=S)
    g = (rng.random((S, N)) < tf[:, None]).astype(int) + (
        rng.random((S, N)) < tf[:, None]
    ).astype(int)
    p_der = np.array([err, 0.5, 1 - err])[g]
    der = rng.binomial(depth, p_der)
    k = der[..., None].astype(float)
    n = depth[..., None].astype(float)
    p = np.array([err, 0.5, 1 - err])[None, None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        ll = k * np.log(p) + (n - k) * np.log1p(-p)
    ll = np.where(n == 0, 0.0, ll)
    gl = np.exp(ll - ll.max(-1, keepdims=True))
    return gl / gl.sum(-1, keepdims=True)


def test_est_maf_macro_tracks_exact_damped():
    """Macro-stepping (speed mode) must track the exact damped iterate to
    <= 1e-4 on realistic low-coverage GLs (VERDICT round-2 gate), at
    every schedule tier, including the F==1 het-floor case."""
    rng = np.random.default_rng(77)
    for N in (32, 100, 160):
        S = 3000
        gl = _realistic_gls(rng, S, N)
        F = rng.random((S, N)) * 0.9
        F[0, :] = 1.0  # het-floor tier
        gl_j = jnp.asarray(gl)
        F_j = jnp.asarray(F)
        exact = np.asarray(est_maf(gl_j, F_j, linear=True))
        fast = np.asarray(est_maf(gl_j, F_j, linear=True, macro=True))
        d = np.abs(exact - fast)
        assert d.max() <= 1e-4, f"N={N}: macro drift {d.max():.2e}"


def test_est_maf_macro_small_n_is_exact():
    """macro=True below the schedule threshold (N < 32) resolves to the
    exact damped loop -- tiny-N cases (like the 6x500 golden matrix)
    must not pay linearisation error."""
    rng = np.random.default_rng(78)
    S, N = 400, 8
    gl = jnp.asarray(_realistic_gls(rng, S, N))
    F = jnp.asarray(rng.random((S, N)) * 0.9)
    exact = np.asarray(est_maf(gl, F, linear=True))
    auto = np.asarray(est_maf(gl, F, linear=True, macro=True))
    np.testing.assert_array_equal(auto, exact)


def test_est_maf_macro_sharded_matches_serial():
    """Macro-stepping under an ind-sharded mesh (psum'd jvp evaluations,
    K0 + ~6 collectives instead of ~101) equals the serial macro path."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    rng = np.random.default_rng(80)
    S, N = 500, 64
    gl = jnp.asarray(_realistic_gls(rng, S, N))
    F = jnp.asarray(rng.random((S, N)) * 0.9)
    # force the sharded run onto the SAME schedule the serial call picks
    # (shard-local width differs; the policy is documented local-width)
    from ngsf_hmm.ops.maf import macro_schedule

    sched = macro_schedule(N)
    want = est_maf(gl, F, linear=True, macro=sched)

    mesh = Mesh(np.array(jax.devices()[:4]), ("ind",))
    fn = shard_map(
        lambda g, f: est_maf(g, f, linear=True, macro=sched,
                             axis_name="ind"),
        mesh=mesh,
        in_specs=(P(None, "ind", None), P(None, "ind")),
        out_specs=P(),
        check_vma=False,
    )
    got = jax.jit(fn)(gl, F)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-10, atol=1e-12
    )


def test_est_maf_f32_linear_matches_f64():
    """The speed tiers' f32 linear-space fixed point reproduces the f64
    log-space one (same damped-accumulator trajectories) across a
    ragged site count."""
    rng = np.random.default_rng(5)
    S, N = 1100, 7
    raw = rng.random((S, N, 3)) + 1e-4
    gl_lin = raw / raw.sum(-1, keepdims=True)
    p_ibd = rng.random((S, N))
    want = np.asarray(est_maf(jnp.asarray(np.log(gl_lin)),
                              jnp.asarray(p_ibd)))
    got = np.asarray(est_maf(jnp.asarray(gl_lin, jnp.float32),
                             jnp.asarray(p_ibd, jnp.float32), linear=True))
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("S,N", [(2100, 100), (1536, 96)])
def test_est_maf_macro_f32_drift(S, N):
    """In f32 (the speed tiers' dtype) macro-stepping tracks the exact
    damped iterate to <= 1e-4, het-floor row included."""
    rng = np.random.default_rng(91)
    gl = jnp.asarray(_realistic_gls(rng, S, N), jnp.float32)
    F = rng.random((S, N)) * 0.9
    F[5, :] = 1.0  # het-floor row
    F = jnp.asarray(F, jnp.float32)
    exact = np.asarray(est_maf(gl, F, linear=True))
    fast = np.asarray(est_maf(gl, F, linear=True, macro=True))
    assert np.isfinite(fast).all()
    assert np.abs(exact - fast).max() <= 1e-4


@pytest.mark.parametrize("macro", [False, True])
def test_est_maf_het_certain_at_full_ibd(macro):
    """A heterozygote-certain GL at p_ibd == 1 must NOT produce NaN:
    calc_HWE's F==1 het floor (gen_func.cpp:946-956) applies on the
    linear f32 path as on the f64 log path."""
    S, N = 8, 40 if macro else 3  # macro engages from 32 individuals
    gl_lin = np.full((S, N, 3), 1.0 / 3)
    gl_lin[2, 1] = [0.0, 1.0, 0.0]  # het-certain individual
    p_ibd = np.zeros((S, N))
    p_ibd[2, :] = 1.0  # fully-IBD site
    with np.errstate(divide="ignore"):
        want = np.asarray(est_maf(jnp.asarray(np.log(gl_lin)),
                                  jnp.asarray(p_ibd)))
    got = np.asarray(est_maf(jnp.asarray(gl_lin, jnp.float32),
                             jnp.asarray(p_ibd, jnp.float32), linear=True,
                             macro=macro))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 if macro else 2e-6)


def test_em_iteration_pallas_freq_is_xla_macro():
    """em_iteration's Triton tier feeds its own posterior to the XLA
    macro fixed point: the iteration's freq is exactly that."""
    from ngsf_hmm.models.em import em_iteration, init_state

    rng = np.random.default_rng(402)
    S, N = 900, 40
    gl_lin = _realistic_gls(rng, S, N)
    gl = jnp.log(jnp.asarray(gl_lin, jnp.float32))
    dist = jnp.full((S,), 1e-5, jnp.float32)
    st = init_state(
        gl, jnp.full((S,), 0.2, jnp.float32),
        jnp.full((N,), 0.3, jnp.float32), jnp.full((N,), 0.05, jnp.float32),
    )
    st2, _ = em_iteration(gl, dist, st, numerics="pallas")
    want = np.asarray(
        est_maf(jnp.exp(gl), st2.p_ibd, linear=True, macro=True)
    )
    np.testing.assert_allclose(np.asarray(st2.freq), want, atol=3e-5)
