"""Multi-restart protocol (ngsF-HMM.sh:9,83-116 equivalent).

Replicates run vmapped in lockstep with per-replicate convergence; the
winner is the highest total log-likelihood; replicate 0 reproduces a
plain single run with the same seed."""

import numpy as np
import jax.numpy as jnp
import pytest

from ngsf_hmm.models.em import EMOptions, init_state, run_em
from ngsf_hmm.models.restart import (
    run_em_restarts,
    stack_restart_states,
)
from ngsf_hmm.io.gsl_rng import GslTaus
from ngsf_hmm.io.init import init_freq, init_indF_alpha
from ngsf_hmm.tools.simulate import simulate


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = tmp_path_factory.mktemp("restart")
    simulate(n_ind=4, n_sites=300, freq="0.2", site_pos="r", indF="0.5",
             alpha="0.01", depth="2", error=0.01, seed=99, out=str(d / "sim"))
    from ngsf_hmm.io import readers

    gl = readers.read_geno(str(d / "sim.glf.gz"), 4, 300, probs=True,
                           log_scale=True)
    dist = readers.read_pos_dist(str(d / "sim.pos.gz"), 300) / 1e6
    from ngsf_hmm.ops.hwe import post_prob

    gl_j = post_prob(jnp.asarray(gl), None)
    return gl_j, jnp.asarray(dist)


def test_restarts_match_independent_runs(sim):
    gl, dist = sim
    opts = EMOptions(min_iters=3, max_iters=12, min_epsilon=1e-4)
    R, seed = 3, 17

    states = stack_restart_states(gl, R, seed)
    rres = run_em_restarts(gl, dist, states, opts)

    # each replicate == an independent run seeded with seed+r
    for r in range(R):
        rng = GslTaus(seed + r)
        indF0, alpha0 = init_indF_alpha("r", gl.shape[1], rng)
        freq0 = init_freq("r", gl.shape[0], rng, gl=gl)
        st = init_state(gl, jnp.asarray(freq0), jnp.asarray(indF0),
                        jnp.asarray(alpha0))
        res = run_em(gl, dist, st, opts)
        assert rres.rep_lkl[r] == pytest.approx(res.tot_lkl, rel=1e-10), r
        assert rres.rep_iters[r] == res.n_iters, r

    # winner is the argmax and carries its own state/path
    assert rres.best_rep == int(np.argmax(rres.rep_lkl))
    assert rres.best.tot_lkl == pytest.approx(max(rres.rep_lkl))
    assert rres.best.path.shape == (gl.shape[0], gl.shape[1])


def test_restart_cli_flag(sim, tmp_path, monkeypatch):
    gl, dist = sim
    del gl, dist
    import contextlib
    import io
    import os

    from ngsf_hmm.cli import main

    d = tmp_path
    simulate(n_ind=4, n_sites=300, freq="0.2", site_pos="r", indF="0.5",
             alpha="0.01", depth="2", error=0.01, seed=99, out=str(d / "sim"))
    cwd = os.getcwd()
    buf = io.StringIO()
    try:
        os.chdir(d)
        with contextlib.redirect_stdout(buf):
            rc = main(
                "--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 4 "
                "--n_sites 300 --freq r --indF r --seed 5 --n_rep 3 "
                "--min_iters 3 --max_iters 10 --min_epsilon 1e-4 "
                "--out multi".split()
            )
    finally:
        os.chdir(cwd)
    assert rc == 0
    out = buf.getvalue()
    assert "Replicate 1:" in out and "<== best" in out
    first = float((d / "multi.indF").read_text().splitlines()[0])
    # the .indF header is the best replicate's total log-likelihood
    best = max(
        float(line.split()[3]) for line in out.splitlines()
        if line.startswith("Replicate")
    )
    assert first == pytest.approx(best, abs=1e-4)


def test_restarts_pallas_matches_linear(sim):
    """The flattened-replicate pallas path (em_iteration n_rep contract)
    must agree with the vmapped linear path replicate-by-replicate."""
    gl, dist = sim
    R, seed = 3, 17
    opts_lin = EMOptions(min_iters=2, max_iters=6, min_epsilon=1e-4,
                         numerics="linear", block_size="auto")
    opts_pal = EMOptions(min_iters=2, max_iters=6, min_epsilon=1e-4,
                         numerics="pallas")

    gl32 = gl.astype(jnp.float32)
    states = stack_restart_states(gl32, R, seed)
    r_lin = run_em_restarts(gl32, jnp.asarray(dist, jnp.float32), states,
                            opts_lin)
    r_pal = run_em_restarts(gl32, jnp.asarray(dist, jnp.float32), states,
                            opts_pal)

    np.testing.assert_allclose(r_pal.rep_lkl, r_lin.rep_lkl, rtol=2e-5)
    np.testing.assert_array_equal(r_pal.rep_iters, r_lin.rep_iters)
    # argmax can flip between numerics paths when replicates converge to
    # the same optimum; the winning LIKELIHOOD must agree regardless
    assert r_pal.best.tot_lkl == pytest.approx(r_lin.best.tot_lkl, rel=2e-5)
    np.testing.assert_allclose(
        np.asarray(r_pal.best.state.indF),
        np.asarray(r_lin.best.state.indF), atol=2e-4,
    )
    np.testing.assert_allclose(
        np.asarray(r_pal.best.state.freq),
        np.asarray(r_lin.best.state.freq), atol=2e-4,
    )
