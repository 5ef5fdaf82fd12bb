"""Checkpoint/resume: a run interrupted at iteration k and resumed must
finish with results identical to an uninterrupted run (exact resume,
including the convergence bookkeeping of the host loop)."""

import contextlib
import io
import os

import numpy as np
import jax.numpy as jnp
import pytest

from ngsf_hmm.io.checkpoint import load_checkpoint, save_checkpoint
from ngsf_hmm.models.em import EMOptions, init_state, run_em
from ngsf_hmm.tools.simulate import simulate


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    simulate(n_ind=4, n_sites=250, freq="0.2", site_pos="r", indF="0.5",
             alpha="0.01", depth="2", error=0.01, seed=7, out=str(d / "sim"))
    from ngsf_hmm.io import readers
    from ngsf_hmm.ops.hwe import post_prob

    gl = readers.read_geno(str(d / "sim.glf.gz"), 4, 250, probs=True,
                           log_scale=True)
    dist = readers.read_pos_dist(str(d / "sim.pos.gz"), 250) / 1e6
    gl_j = post_prob(jnp.asarray(gl), None)
    return gl_j, jnp.asarray(dist), d


def _fresh_state(gl):
    S, N = gl.shape[0], gl.shape[1]
    return init_state(
        gl,
        jnp.full((S,), 0.15, gl.dtype),
        jnp.full((N,), 0.3, gl.dtype),
        jnp.full((N,), 0.05, gl.dtype),
    )


def test_exact_resume(data, tmp_path):
    gl, dist, _ = data
    opts = EMOptions(min_iters=4, max_iters=15, min_epsilon=1e-4)
    ck = str(tmp_path / "run.ckpt.npz")

    # uninterrupted run
    full = run_em(gl, dist, _fresh_state(gl), opts)

    # interrupted at iteration 3 via an exception from the checkpoint cb
    class Stop(Exception):
        pass

    saved = {}

    def cb(n_iter, st, bk):
        save_checkpoint(ck, st, bk)
        saved["n"] = n_iter
        if n_iter == 3:
            raise Stop

    with pytest.raises(Stop):
        run_em(gl, dist, _fresh_state(gl), opts, checkpoint_cb=cb)
    assert saved["n"] == 3

    st, bk = load_checkpoint(ck)
    assert bk["n_iter"] == 3
    resumed = run_em(gl, dist, st, opts, resume_bookkeeping=bk)

    assert resumed.n_iters == full.n_iters
    assert resumed.tot_lkl == pytest.approx(full.tot_lkl, rel=1e-14)
    np.testing.assert_array_equal(resumed.path, full.path)
    for f in ("freq", "indF", "alpha"):
        np.testing.assert_allclose(
            np.asarray(getattr(resumed.state, f)),
            np.asarray(getattr(full.state, f)),
            rtol=1e-13,
        )


def test_checkpoint_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.npz"
    np.savez(bad, __meta__=np.frombuffer(b'{"format": "nope"}', dtype=np.uint8))
    with pytest.raises(ValueError, match="not a ngsf-hmm-ckpt"):
        load_checkpoint(str(bad))


def test_cli_checkpoint_resume(data, tmp_path):
    _, _, simdir = data
    from ngsf_hmm.cli import main

    args = (
        "--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 4 --n_sites 250 "
        "--freq 0.15 --indF 0.3,0.05 --min_iters 4 --max_iters 12 "
        "--min_epsilon 1e-4 --checkpoint run.ck "
    )
    cwd = os.getcwd()
    try:
        os.chdir(simdir)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main((args + "--out a").split())
        assert rc == 0
        # resume from the final checkpoint: converges immediately, outputs
        # must match the completed run's
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main((args + "--resume --out b").split())
        assert rc == 0
        assert "Resuming from" in buf.getvalue()
        a = (simdir / "a.indF").read_text()
        b = (simdir / "b.indF").read_text()
        assert a == b
    finally:
        os.chdir(cwd)


def test_cli_resume_without_checkpoint_errors(data):
    from ngsf_hmm.cli import main

    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(SystemExit):
            main(
                "--geno x --pos y --n_ind 2 --n_sites 10 --resume".split()
            )


def test_restart_exact_resume(data, tmp_path):
    """Multi-restart run interrupted mid-flight and resumed must match an
    uninterrupted run exactly (per-replicate bookkeeping incl. frozen
    replicates survives the round-trip)."""
    gl, dist, _ = data
    from ngsf_hmm.models.restart import (
        run_em_restarts,
        stack_restart_states,
    )

    opts = EMOptions(min_iters=3, max_iters=12, min_epsilon=1e-4)
    states0 = stack_restart_states(gl, 3, 11, indF_spec="r", freq_spec="0.15")
    ck = str(tmp_path / "rep.ckpt.npz")

    full = run_em_restarts(gl, dist, states0, opts)

    class Stop(Exception):
        pass

    def cb(n_iter, sts, bk):
        save_checkpoint(ck, sts, bk)
        if n_iter == 4:
            raise Stop

    with pytest.raises(Stop):
        run_em_restarts(gl, dist, states0, opts, checkpoint_cb=cb)

    st, bk = load_checkpoint(ck)
    assert bk["n_iter"] == 4
    assert np.asarray(bk["active"]).shape == (3,)
    res = run_em_restarts(gl, dist, st, opts, resume_bookkeeping=bk)

    assert res.best_rep == full.best_rep
    np.testing.assert_array_equal(res.rep_iters, full.rep_iters)
    np.testing.assert_allclose(res.rep_lkl, full.rep_lkl, rtol=1e-13)
    np.testing.assert_array_equal(res.best.path, full.best.path)
    for f in ("freq", "indF", "alpha"):
        np.testing.assert_allclose(
            np.asarray(getattr(res.best.state, f)),
            np.asarray(getattr(full.best.state, f)),
            rtol=1e-13,
        )


def test_cli_checkpoint_n_rep(data, tmp_path):
    """--checkpoint/--resume with --n_rep > 1: resume from the final
    checkpoint reproduces the completed run; replicate-count mismatch is
    rejected."""
    _, _, simdir = data
    from ngsf_hmm.cli import main

    args = (
        "--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 4 --n_sites 250 "
        "--freq 0.15 --indF r --seed 5 --n_rep 3 --min_iters 3 --max_iters 10 "
        "--min_epsilon 1e-4 --checkpoint rep.ck "
    )
    cwd = os.getcwd()
    try:
        os.chdir(simdir)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main((args + "--out ra").split())
        assert rc == 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main((args + "--resume --out rb").split())
        assert rc == 0
        assert "Resuming from" in buf.getvalue()
        assert (simdir / "ra.indF").read_text() == (simdir / "rb.indF").read_text()
        # replicate-count mismatch must be rejected
        bad = args.replace("--n_rep 3", "--n_rep 2")
        with contextlib.redirect_stdout(io.StringIO()):
            with pytest.raises(SystemExit):
                main((bad + "--resume --out rc").split())
    finally:
        os.chdir(cwd)


def test_graceful_stop_signal(data):
    """SIGINT between iterations stops the loop cleanly (SIG_COND gate,
    EM.cpp:56) but the run still produces outputs."""
    gl, dist, _ = data
    from ngsf_hmm.utils import signals

    signals.reset()
    opts = EMOptions(min_iters=2, max_iters=50, min_epsilon=1e-9)
    calls = {"n": 0}

    def cb(n_iter, st, bk):
        calls["n"] = n_iter
        if n_iter == 2:
            import os
            import signal as _s

            signals.catch_sig()
            os.kill(os.getpid(), _s.SIGINT)

    res = run_em(gl, dist, _fresh_state(gl), opts, checkpoint_cb=cb)
    assert res.n_iters == 2  # stopped at the boundary after iteration 2
    assert res.path.shape[0] == gl.shape[0]  # final Viterbi still ran
    signals.reset()


def test_nan_state_aborts(data):
    """NaN in the recursions must abort like the reference (HMM.cpp:18-21)
    -- a plain `d > tol` comparison is False for NaN and would silently
    continue."""
    gl, dist, _ = data
    import jax.numpy as jnp

    bad = jnp.asarray(np.asarray(gl).copy())
    bad = bad.at[5, 1].set(jnp.nan)
    opts = EMOptions(min_iters=2, max_iters=4, min_epsilon=1e-3)
    with pytest.raises(RuntimeError, match="Fw and Bw"):
        run_em(bad, dist, _fresh_state(bad), opts)


def test_cli_mesh_light_checkpoint_resume(data, tmp_path):
    """Mesh runs checkpoint params-only (freq/indF/alpha: O(S+N), not the
    O(S*N) full state); a resumed run rebuilds the in-loop emissions and
    finishes byte-identical to the uninterrupted run; a terminal resume
    errors instead of writing the zeroed p_ibd/ind_lkl placeholders."""
    import numpy as np

    from ngsf_hmm.cli import main
    from ngsf_hmm.io.checkpoint import checkpoint_format

    _, _, simdir = data
    base = (
        "--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 4 "
        "--n_sites 250 --freq 0.15 --indF 0.3,0.05 --min_iters 2 "
        "--min_epsilon 1e-9 --mesh ind=1,site=4 "  # 250 pads to 252
    )
    cwd = os.getcwd()
    try:
        os.chdir(simdir)
        with contextlib.redirect_stdout(io.StringIO()):
            assert main((base + "--max_iters 8 --out mA").split()) == 0
        # partial run -> params checkpoint -> resume to the same end
        with contextlib.redirect_stdout(io.StringIO()):
            assert main((base + "--max_iters 4 --checkpoint mesh.ck "
                         "--out mPart").split()) == 0
        assert checkpoint_format("mesh.ck") == "params"
        with np.load("mesh.ck") as z:
            assert "e_prob" not in z.files and "freq" in z.files
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main((base + "--max_iters 8 --checkpoint mesh.ck "
                         "--resume --out mB").split()) == 0
        assert "params-only checkpoint" in buf.getvalue()
        for ext in (".indF", ".ibd"):
            assert (simdir / ("mB" + ext)).read_text() == \
                (simdir / ("mA" + ext)).read_text(), ext
        # resume is exact to f64 roundoff: the rebuilt emissions can
        # differ from the in-loop values by ~1 ULP (separate XLA
        # programs), which shows only in the binary .geno doubles
        np.testing.assert_allclose(np.fromfile(simdir / "mA.geno"),
                                   np.fromfile(simdir / "mB.geno"),
                                   rtol=1e-12, atol=1e-15)
        # terminal resume (checkpoint saved at max_iters): no iterations
        # would run, p_ibd/ind_lkl are placeholders -> reference error()
        with contextlib.redirect_stdout(io.StringIO()):
            with pytest.raises(SystemExit):
                main((base + "--max_iters 8 --checkpoint mesh.ck "
                      "--resume --out mC").split())
    finally:
        os.chdir(cwd)
