"""Corrected LD path (freq_est=2 / e_prob=2): the two-site haplotype EM
the reference intended but never shipped working (gen_func.cpp:1160 bug).

No golden target exists (the reference NaNs out), so the checks are
semantic: haplotype freqs are a simplex, pair-derived MAFs agree with
the single-site MAFs on LD-free data, EM ascends, and the CLI runs the
path end-to-end."""

import contextlib
import io
import os

import numpy as np
import jax.numpy as jnp
import pytest

from ngsf_hmm.models.em import em_iteration, init_state
from ngsf_hmm.ops.haplo import calc_emission_ld, haplo_freq, joint_geno_prob
from ngsf_hmm.tools.simulate import simulate

RNG = np.random.default_rng(13)


def test_haplo_freq_simplex_and_nan_compat():
    N = 40
    raw1 = RNG.random((N, 3)) + 1e-3
    raw2 = RNG.random((N, 3)) + 1e-3
    pp1 = jnp.asarray(np.log(raw1 / raw1.sum(-1, keepdims=True)))
    pp2 = jnp.asarray(np.log(raw2 / raw2.sum(-1, keepdims=True)))
    f = haplo_freq(pp1, pp2, 0.3, 0.2, compat=False)
    f = np.asarray(f)
    assert f.shape == (4,)
    assert np.all(f >= 0) and abs(f.sum() - 1) < 1e-6
    # compat mode reproduces the reference's NaN outcome
    f_nan = np.asarray(haplo_freq(pp1, pp2, 0.3, 0.2, compat=True))
    assert np.isnan(f_nan).all()


def test_joint_geno_prob_marginals():
    """Summing the pair table over one site must give the HWE genotype
    probabilities of the other site's marginal allele frequency."""
    hap = jnp.asarray([0.5, 0.2, 0.2, 0.1])
    tab = np.asarray(joint_geno_prob(hap, 0))
    assert tab.shape == (3, 3)
    assert abs(tab.sum() - 1) < 1e-12
    maf_c = float(hap[1] + hap[3])
    marg_c = tab.sum(0)
    want = [(1 - maf_c) ** 2, 2 * maf_c * (1 - maf_c), maf_c ** 2]
    np.testing.assert_allclose(marg_c, want, atol=1e-12)
    # inbred table: haploid transmission
    tab1 = np.asarray(joint_geno_prob(hap, 1))
    assert abs(tab1.sum() - 1) < 1e-12
    assert tab1[0, 1] == tab1[1, 1] == 0


def test_ld_em_iteration_runs_and_stabilises():
    S, N = 300, 6
    raw = RNG.random((S, N, 3)) + 1e-3
    gl = jnp.asarray(np.log(raw / raw.sum(-1, keepdims=True)))
    dist = jnp.asarray(np.abs(RNG.random(S)) * 0.01 + 1e-4)
    st = init_state(
        gl,
        jnp.full((S,), 0.2),
        jnp.full((N,), 0.3),
        jnp.full((N,), 0.05),
    )
    lkls = []
    for _ in range(4):
        st, _ = em_iteration(gl, dist, st, freq_est=2, e_prob_calc=2)
        lkls.append(float(np.asarray(st.ind_lkl).sum()))
        assert np.isfinite(np.asarray(st.freq)).all()
        assert np.isfinite(np.asarray(st.e_prob)).all()
    # LD-conditioned emissions change the per-iteration objective (the
    # reference's construction divides out the previous site's emission,
    # HMM.cpp:205-207), so EM monotonicity does not apply; require the
    # trajectory to stay finite and settle instead.
    assert np.isfinite(lkls).all()
    assert abs(lkls[-1] - lkls[-2]) < 0.05 * abs(lkls[-1])
    assert np.all(np.asarray(st.freq) >= 0) and np.all(np.asarray(st.freq) <= 1)


def test_ld_freqs_recover_truth_on_independent_sites():
    """With informative genotypes drawn from known MAFs and no LD, the
    hap-derived MAFs must recover the truth like the single-site MAFs."""
    S, N = 120, 200
    maf_true = RNG.uniform(0.1, 0.4, S)
    geno = RNG.binomial(2, maf_true[:, None], size=(S, N))  # no LD
    gl = np.full((S, N, 3), np.log(0.005))
    for g in range(3):
        gl[..., g] = np.where(geno == g, np.log(0.99), np.log(0.005))
    gl = jnp.asarray(gl - np.log(np.exp(gl).sum(-1, keepdims=True)))
    dist = jnp.asarray(np.abs(RNG.random(S)) * 0.01 + 1e-4)
    st = init_state(gl, jnp.full((S,), 0.2), jnp.full((N,), 0.05),
                    jnp.full((N,), 0.05))
    st_ld, _ = em_iteration(gl, dist, st, freq_est=2, e_prob_calc=1)
    st_m, _ = em_iteration(gl, dist, st, freq_est=1, e_prob_calc=1)
    # both estimators near truth; sampling noise at N=200 is ~0.03
    assert np.abs(np.asarray(st_m.freq)[1:] - maf_true[1:]).mean() < 0.05
    assert np.abs(np.asarray(st_ld.freq)[1:] - maf_true[1:]).mean() < 0.05
    np.testing.assert_allclose(
        np.asarray(st_ld.freq)[1:], np.asarray(st_m.freq)[1:], atol=0.08
    )


def test_cli_ld_path(tmp_path):
    from ngsf_hmm.cli import main

    simulate(n_ind=4, n_sites=200, freq="0.2", site_pos="r", indF="0.5",
             alpha="0.01", depth="2", error=0.01, seed=31, out=str(tmp_path / "sim"))
    cwd = os.getcwd()
    buf = io.StringIO()
    err = io.StringIO()
    try:
        os.chdir(tmp_path)
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = main(
                "--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 4 "
                "--n_sites 200 --freq 0.2 --indF 0.3,0.05 --freq_est 2 "
                "--e_prob 2 --min_iters 2 --max_iters 6 --min_epsilon 1e-3 "
                "--out ld".split()
            )
    finally:
        os.chdir(cwd)
    assert rc == 0
    assert "CORRECTED two-site haplotype EM" in err.getvalue()
    first = float((tmp_path / "ld.indF").read_text().splitlines()[0])
    assert np.isfinite(first)


def _informative_gl(maf, N):
    """[S, N, 3] log GLs with near-certain genotypes drawn from maf [S]."""
    geno = RNG.binomial(2, np.asarray(maf)[:, None], size=(len(maf), N))
    gl = np.full((len(maf), N, 3), np.log(0.005))
    for g in range(3):
        gl[..., g] = np.where(geno == g, np.log(0.99), np.log(0.005))
    return jnp.asarray(gl - np.log(np.exp(gl).sum(-1, keepdims=True)))


def test_ld_init_freq_matches_est_maf_on_independent_sites():
    """Init-time --freq e under --freq_est 2 (parse_args.cpp:316-321):
    site 0 is the plain est_maf(F=0) estimate; later sites come from the
    corrected pair EM and must agree with est_maf on LD-free data."""
    from ngsf_hmm.ops.haplo import ld_init_freq
    from ngsf_hmm.ops.maf import est_maf

    S, N = 80, 200
    maf_true = RNG.uniform(0.1, 0.4, S)
    gl = _informative_gl(maf_true, N)
    freq = np.asarray(ld_init_freq(gl))
    base = np.asarray(est_maf(gl, jnp.zeros((S, N), gl.dtype)))
    assert np.all(np.isfinite(freq)) and np.all((freq > 0) & (freq < 1))
    np.testing.assert_allclose(freq[0], base[0], rtol=1e-12)
    np.testing.assert_allclose(freq[1:], base[1:], atol=0.08)
    assert np.abs(freq[1:] - maf_true[1:]).mean() < 0.05


def test_init_state_ld_emissions():
    """init_state(e_prob_calc=2) (parse_args.cpp:373-386): site 0 keeps
    the plain emission; sites >= 1 carry the LD pair emissions built from
    the corrected pair EM seeded with the initial freqs."""
    S, N = 30, 12
    maf_true = RNG.uniform(0.1, 0.4, S)
    gl = _informative_gl(maf_true, N)
    freq0 = jnp.full((S,), 0.2, gl.dtype)
    indF0 = jnp.full((N,), 0.3, gl.dtype)
    alpha0 = jnp.full((N,), 0.05, gl.dtype)
    st_pl = init_state(gl, freq0, indF0, alpha0)
    st_ld = init_state(gl, freq0, indF0, alpha0, e_prob_calc=2)
    e_pl = np.asarray(st_pl.e_prob)
    e_ld = np.asarray(st_ld.e_prob)
    assert np.all(np.isfinite(e_ld))
    np.testing.assert_array_equal(e_ld[0], e_pl[0])
    assert np.abs(e_ld[1:] - e_pl[1:]).max() > 1e-3  # LD branch engaged
    hap = haplo_freq(gl[:-1], gl[1:], freq0[:-1], freq0[1:], compat=False)
    want = np.stack(
        [
            np.asarray(calc_emission_ld(
                hap[:, None, :], gl[:-1], gl[1:], freq0[:-1, None], k))
            for k in (0, 1)
        ],
        axis=-1,
    )
    np.testing.assert_allclose(e_ld[1:], want, rtol=1e-12)


def test_cli_ld_freq_e_init(tmp_path):
    """--freq e --freq_est 2 exercises the LD freq init end-to-end."""
    from ngsf_hmm.cli import main

    simulate(n_ind=4, n_sites=120, freq="0.2", site_pos="r", indF="0.4",
             alpha="0.02", depth="3", error=0.01, seed=7,
             out=str(tmp_path / "sim"))
    cwd = os.getcwd()
    buf, err = io.StringIO(), io.StringIO()
    try:
        os.chdir(tmp_path)
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = main(
                "--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 4 "
                "--n_sites 120 --freq e --indF 0.3,0.05 --freq_est 2 "
                "--min_iters 2 --max_iters 5 --min_epsilon 1e-3 "
                "--out ldf".split()
            )
    finally:
        os.chdir(cwd)
    assert rc == 0
    # indF at a bound prints "NA" for alpha (EM.cpp:308-310 parity)
    vals = [float(x) for x in (tmp_path / "ldf.indF").read_text().split()
            if x != "NA"]
    assert np.all(np.isfinite(vals))
