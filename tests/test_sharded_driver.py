"""End-to-end sharded runs (parallel/driver.run_em_sharded) vs the
single-device engine: same converged parameters, paths and outputs."""

import numpy as np
import jax.numpy as jnp
import pytest

from ngsf_hmm.models.em import EMOptions, init_state, run_em
from ngsf_hmm.models.restart import stack_restart_states
from ngsf_hmm.parallel.driver import parse_mesh_spec, run_em_sharded


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(33)
    S, N = 150, 16  # S deliberately NOT divisible by 8 (site padding)
    gl = np.log(rng.dirichlet(np.ones(3), size=(S, N)))
    dist = rng.uniform(0.01, 0.3, size=S)
    dist[0] = 1.0
    freq0 = rng.uniform(0.05, 0.45, size=S)
    indF0 = rng.uniform(0.05, 0.9, size=N)
    alpha0 = rng.uniform(0.01, 0.5, size=N)
    gl_j = jnp.asarray(gl)
    state = init_state(
        gl_j, jnp.asarray(freq0), jnp.asarray(indF0), jnp.asarray(alpha0)
    )
    return gl_j, jnp.asarray(dist), state


OPTS = EMOptions(min_iters=3, max_iters=12, min_epsilon=1e-4)


def test_parse_mesh_spec():
    assert parse_mesh_spec("2x4") == {"restart": 2, "ind": 4, "site": 1}
    assert parse_mesh_spec("1x2x4") == {"restart": 1, "ind": 2, "site": 4}
    assert parse_mesh_spec("ind=8") == {"restart": 1, "ind": 8, "site": 1}
    assert parse_mesh_spec("site=4,ind=2") == {
        "restart": 1, "ind": 2, "site": 4,
    }
    with pytest.raises(ValueError):
        parse_mesh_spec("foo=3")
    with pytest.raises(ValueError):
        parse_mesh_spec("2x0")
    with pytest.raises(ValueError):
        parse_mesh_spec("restart=2,site=4")


@pytest.mark.parametrize(
    "spec", ["ind=8", "site=8", "ind=2,site=4"], ids=["ind", "site", "grid"]
)
def test_full_run_matches_single_device(case, spec):
    gl, dist, state = case
    ref = run_em(gl, dist, state, OPTS)
    got = run_em_sharded(gl, dist, state, OPTS, parse_mesh_spec(spec))

    assert got.n_iters == ref.n_iters
    assert got.converged == ref.converged
    tol = 1e-8 if spec == "ind=8" else 2e-3
    np.testing.assert_allclose(got.tot_lkl, ref.tot_lkl, rtol=tol)
    np.testing.assert_allclose(
        np.asarray(got.state.indF), np.asarray(ref.state.indF), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(got.state.alpha), np.asarray(ref.state.alpha), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(got.state.freq), np.asarray(ref.state.freq), atol=5e-4
    )
    mism = int((got.path != ref.path).sum())
    assert mism <= 0.002 * got.path.size
    assert got.path.shape == ref.path.shape


@pytest.mark.parametrize(
    "spec", ["ind=8", "site=8", "ind=2,site=4"], ids=["ind", "site", "grid"]
)
def test_full_run_pallas_matches_single_device(case, spec):
    """numerics='pallas' end-to-end on every mesh layout: the ind mesh
    runs the full pallas tier shard-local, the site/grid meshes run the
    pallas chain + carries (and the pallas freq fixed point on the pure
    site mesh); all must match the single-device pallas engine."""
    import dataclasses

    gl, dist, state = case
    gl32 = gl.astype(jnp.float32)
    dist32 = dist.astype(jnp.float32)
    st32 = type(state)(*(x.astype(jnp.float32) for x in state))
    # pinned iteration count: f32 reduction-order noise between the two
    # est_maf/chain orderings flips the loose 1e-4 epsilon gate at this
    # tiny config, and the test's claim is ENDPOINT equivalence
    opts = dataclasses.replace(
        OPTS, numerics="pallas", min_iters=6, max_iters=6
    )
    ref = run_em(gl32, dist32, st32, opts)
    got = run_em_sharded(gl32, dist32, st32, opts, parse_mesh_spec(spec))

    assert got.n_iters == ref.n_iters
    np.testing.assert_allclose(got.tot_lkl, ref.tot_lkl, rtol=2e-3)
    np.testing.assert_allclose(
        np.asarray(got.state.indF), np.asarray(ref.state.indF), atol=2e-3
    )
    # alpha is near-unidentifiable on this random-GL fixture (most
    # entries sit on the 1e-15/10 bounds; at alpha > 1 the transitions
    # are ~stationary for these distances and the likelihood goes flat),
    # so two f32 engines with decorrelated rounding land visibly apart
    # at the same likelihood -- compare alpha only in its determined
    # regime and lean on tot_lkl/indF/freq/path for the equivalence claim
    al_g = np.asarray(got.state.alpha)
    al_r = np.asarray(ref.state.alpha)
    det = (al_g <= 1.0) & (al_r <= 1.0)
    np.testing.assert_allclose(al_g[det], al_r[det], atol=0.25)
    np.testing.assert_allclose(
        np.asarray(got.state.freq), np.asarray(ref.state.freq), atol=3e-3
    )
    mism = int((got.path != ref.path).sum())
    assert mism <= max(3, 0.002 * got.path.size)


def test_site_mesh_f64_compat_is_exact(case):
    """opts.numerics='log' keeps the site-sharded kernels in f64
    (work_dtype follows the input dtype): per-iteration results should
    then agree with the single-device blocked-linear engine to f64
    accuracy, padding included."""
    gl, dist, state = case
    import dataclasses

    opts = dataclasses.replace(OPTS, max_iters=4, min_iters=2)
    ref = run_em(
        gl, dist, state,
        dataclasses.replace(opts, numerics="linear", block_size="auto"),
    )
    got = run_em_sharded(gl, dist, state, opts, parse_mesh_spec("site=8"))
    np.testing.assert_allclose(got.tot_lkl, ref.tot_lkl, rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(got.state.indF), np.asarray(ref.state.indF), atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(got.state.freq), np.asarray(ref.state.freq), atol=1e-8
    )


def test_restart_mesh_matches_host_restarts(case):
    gl, dist, _ = case
    R = 4
    states = stack_restart_states(gl, R, seed=99)
    from ngsf_hmm.models.restart import run_em_restarts

    ref = run_em_restarts(gl, dist, states, OPTS)
    got = run_em_sharded(
        gl, dist, states, OPTS, parse_mesh_spec("restart=2,ind=4")
    )
    assert got.best_rep == ref.best_rep
    np.testing.assert_allclose(got.rep_lkl, ref.rep_lkl, rtol=1e-9)
    np.testing.assert_array_equal(got.rep_iters, ref.rep_iters)
    np.testing.assert_allclose(
        np.asarray(got.best.state.indF),
        np.asarray(ref.best.state.indF),
        atol=1e-9,
    )
    np.testing.assert_array_equal(got.best.path, ref.best.path)


def test_sharded_checkpoint_resume(case, tmp_path):
    """A sharded run checkpointed mid-way resumes to the same answer,
    and its checkpoints interoperate with io/checkpoint.py."""
    gl, dist, state = case
    from ngsf_hmm.io.checkpoint import load_checkpoint, save_checkpoint

    spec = parse_mesh_spec("ind=8")
    full = run_em_sharded(gl, dist, state, OPTS, spec)

    path = tmp_path / "ck.npz"

    class Stop(Exception):
        pass

    def cb(n_iter, st, bk):
        save_checkpoint(str(path), st, bk)
        if n_iter == 2:
            raise Stop

    with pytest.raises(Stop):
        run_em_sharded(gl, dist, state, OPTS, spec, checkpoint_cb=cb)

    st, bk = load_checkpoint(str(path))
    resumed = run_em_sharded(
        gl, dist, st, OPTS, spec, resume_bookkeeping=bk
    )
    assert resumed.n_iters == full.n_iters
    np.testing.assert_allclose(resumed.tot_lkl, full.tot_lkl, rtol=1e-12)
    np.testing.assert_array_equal(resumed.path, full.path)


def test_cli_mesh_run(tmp_path, monkeypatch):
    """`python -m ngsf_hmm --mesh ...` produces outputs matching the
    single-device CLI run (VERDICT item 1's done-criterion). Small
    forced gather windows make the chunked final writers cross several
    site-chunk and ind-block boundaries (incl. clamped last windows:
    220 sites pad to 222 on site=2)."""
    import contextlib
    import io
    import os
    import pathlib

    from ngsf_hmm.cli import main
    from ngsf_hmm.tools.simulate import simulate

    monkeypatch.setenv("NGSF_GENO_GATHER_CHUNK", "64")
    monkeypatch.setenv("NGSF_IBD_GATHER_INDS", "3")

    d = tmp_path
    simulate(n_ind=8, n_sites=220, freq="0.2", indF="0.5", alpha="0.01",
             depth="2", error=0.01, seed=7, out=str(d / "sim"))
    base = (
        "--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 8 "
        "--n_sites 220 --freq 0.2 --indF 0.2,0.05 --seed 5 "
        "--max_iters 20 --verbose 1"
    )

    cwd = os.getcwd()
    try:
        os.chdir(d)
        for extra, out in (("", "plain"), ("--mesh ind=4,site=2", "mesh")):
            with contextlib.redirect_stdout(io.StringIO()):
                rc = main((base + f" {extra} --out {out}").split())
            assert rc == 0
    finally:
        os.chdir(cwd)

    # .indF: parsed comparison (psum/collective reduction order makes
    # byte-identity too strict for live-M-step runs)
    def read_indf(p):
        lines = pathlib.Path(p).read_text().splitlines()
        return (
            float(lines[0]),
            np.array([[float(x) if x != "NA" else np.nan for x in l.split("\t")]
                      for l in lines[1:9]]),
            np.array([float(x) for x in lines[9:]]),
        )

    tot_p, Fa_p, fr_p = read_indf(d / "plain.indF")
    tot_m, Fa_m, fr_m = read_indf(d / "mesh.indF")
    assert tot_m == pytest.approx(tot_p, rel=1e-4)
    np.testing.assert_allclose(Fa_m, Fa_p, atol=5e-3)
    np.testing.assert_allclose(fr_m, fr_p, atol=1e-3)

    ibd_p = (d / "plain.ibd").read_text().splitlines()
    ibd_m = (d / "mesh.ibd").read_text().splitlines()
    # viterbi path rows: identical
    assert ibd_m[1:9] == ibd_p[1:9]
    geno_p = np.fromfile(d / "plain.geno")
    geno_m = np.fromfile(d / "mesh.geno")
    np.testing.assert_allclose(geno_m, geno_p, atol=5e-3)


def test_cli_mesh_ld_fails_fast(tmp_path, capsys):
    """--mesh + the LD path (--freq_est 2 / --e_prob 2) must error at
    arg-parse time -- before any IO or the pair-EM init -- since
    run_em_sharded rejects it anyway (parallel/driver.py)."""
    from ngsf_hmm.cli import main

    for flag in ("--freq_est 2", "--e_prob 2"):
        with pytest.raises(SystemExit) as ei:
            main(
                f"--geno does_not_exist.glf.gz --pos nope.pos.gz "
                f"--n_ind 4 --n_sites 10 "
                f"--mesh ind=2 {flag} --out x".split()
            )
        assert ei.value.code == 1
        err = capsys.readouterr().err
        # the LD guard, not a file-not-found from the reader
        assert "LD path" in err and "mesh" in err


def test_sharded_trace_state_lazy_view(case):
    """iter_done trace handlers get a state whose attributes resolve to
    the gathered UNPADDED host view (verbose >= 4 CLI handlers index
    indF/e_prob directly; raw padded device state would be wrong on
    multi-process meshes and off-by-pad on site meshes)."""
    gl, dist, state = case
    S, N = gl.shape[0], gl.shape[1]
    seen = []

    def trace(event, **kw):
        if event != "iter_done":
            return
        st = kw["state"]
        seen.append(
            (np.asarray(st.indF).copy(), np.asarray(st.e_prob).shape,
             float(np.asarray(st.freq)[0]))
        )

    opts = EMOptions(min_iters=2, max_iters=3, min_epsilon=1e-9)
    res = run_em_sharded(
        gl, dist, state, opts, parse_mesh_spec("site=8"), trace=trace
    )
    assert len(seen) == res.n_iters
    indF_last, e_shape, f0 = seen[-1]
    assert e_shape == (S, N, 2)  # unpadded (150 pads to 152 on site=8)
    np.testing.assert_allclose(indF_last, np.asarray(res.state.indF),
                               rtol=1e-6)
    assert np.isfinite(f0)


def test_gather_final_false_device_results(case):
    """gather_final=False keeps e_prob/p_ibd/path device-resident and
    PADDED while the run itself matches the gathered variant bit for
    bit; fetch_chunk windows (with the dynamic-slice clamp compensated)
    reassemble the exact gathered arrays."""
    from ngsf_hmm.parallel.distributed import fetch_chunk

    gl, dist, state = case
    S, N = gl.shape[0], gl.shape[1]
    spec = parse_mesh_spec("site=8")
    full = run_em_sharded(gl, dist, state, OPTS, spec)
    dev = run_em_sharded(gl, dist, state, OPTS, spec, gather_final=False)

    assert dev.tot_lkl == full.tot_lkl
    assert dev.n_iters == full.n_iters
    assert dev.path.shape[0] == 152  # 150 padded to the 8-shard multiple
    assert dev.state.p_ibd.shape[0] == 152
    np.testing.assert_array_equal(np.asarray(dev.state.freq),
                                  np.asarray(full.state.freq))

    # site windows over the padded device path == gathered unpadded path
    C = 48
    rows = []
    for s0 in range(0, S, C):
        s0_eff = min(s0, dev.path.shape[0] - C)
        w = fetch_chunk(dev.path, 0, s0_eff, C)
        off = s0 - s0_eff
        rows.append(w[off:off + min(C, S - s0)])
    np.testing.assert_array_equal(np.concatenate(rows), full.path)

    # an ind block of the device p_ibd == the gathered columns
    blk = fetch_chunk(dev.state.p_ibd, 1, 5, 4)[:S]
    np.testing.assert_array_equal(blk, np.asarray(full.state.p_ibd)[:, 5:9])

    with pytest.raises(ValueError):  # restarts need the gathered axis
        states_r = stack_restart_states(gl, 2, seed=1)
        run_em_sharded(gl, dist, states_r, OPTS,
                       parse_mesh_spec("restart=2,ind=4"),
                       gather_final=False)
