"""Streaming EM (host-resident GLs in chunks) vs the monolithic engine.

The boundary-carry algebra must make chunking invisible: full EM
trajectories on chunked data (including a ragged last chunk and a
chromosome break ON a chunk boundary) must match the monolithic linear
engine within optimizer-endpoint tolerances (the M-step optimizer is the
host L-BFGS mirror, so endpoints can differ at the 1e-4 level)."""

import contextlib
import io

import numpy as np
import jax.numpy as jnp
import pytest

from ngsf_hmm.models.em import EMOptions, em_iteration, init_state
from ngsf_hmm.models.streaming import StreamingEM


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    S, N = 1000, 5
    raw = rng.random((S, N, 3)) + 1e-3
    gl = np.log(raw / raw.sum(-1, keepdims=True))
    dist = np.abs(rng.random(S)) * 0.05
    dist[0] = 0.4
    dist[300] = np.inf  # chromosome break ON the chunk boundary (cs=300)
    dist[777] = np.inf  # and one mid-chunk
    return gl, dist


def test_streaming_matches_monolithic(data):
    gl, dist = data
    S, N = gl.shape[0], gl.shape[1]
    freq0 = np.full(S, 0.2)
    F0 = np.linspace(0.1, 0.6, N)
    a0 = np.linspace(0.02, 0.2, N)
    opts = EMOptions(min_iters=3, max_iters=8, min_epsilon=1e-4)

    # monolithic linear engine
    gl_j = jnp.asarray(gl, jnp.float32)
    dist_j = jnp.asarray(dist, jnp.float32)
    st = init_state(gl_j, jnp.asarray(freq0, jnp.float32),
                    jnp.asarray(F0, jnp.float32), jnp.asarray(a0, jnp.float32))
    iters_mono = 0
    prev_tot = tot = 0.0
    prev_ind = np.full(N, -np.inf)
    max_eps = -np.inf
    from ngsf_hmm.models.em import _array_max_pos

    while ((prev_tot - tot > opts.min_epsilon or max_eps > opts.min_epsilon
            or iters_mono < opts.min_iters) and iters_mono < opts.max_iters):
        iters_mono += 1
        st, _ = em_iteration(gl_j, dist_j, st, block_size="auto",
                             numerics="linear")
        ind = np.asarray(st.ind_lkl, np.float64)
        prev_tot, tot = tot, float(ind.sum())
        with np.errstate(invalid="ignore"):
            eps = (ind - prev_ind) / np.abs(prev_ind)
        max_eps = eps[_array_max_pos(eps)]
        prev_ind = ind

    # streaming engine: 4 chunks of 300 (ragged last = 100 sites)
    p_out = np.zeros((S, N))
    se = StreamingEM(gl, dist, chunk_sites=300)
    assert se.C == 4
    freq_s, F_s, a_s, ll_s, iters_s = se.run(freq0, F0, a0, opts,
                                             p_ibd_out=p_out)

    assert iters_s == iters_mono
    np.testing.assert_allclose(ll_s, np.asarray(st.ind_lkl), rtol=2e-5)
    np.testing.assert_allclose(freq_s, np.asarray(st.freq), atol=5e-4)
    F_m = np.asarray(st.indF)
    np.testing.assert_allclose(F_s, F_m, atol=2e-3)
    # alpha is unidentifiable where F sits on a bound (the chain is all-
    # non-IBD/all-IBD regardless of the rate; the reference itself
    # prints alpha = NA there, EM.cpp:306-313) -- the two optimizer
    # backends legitimately park it at different points on the flat
    ident = (F_m > 1e-5) & (F_m < 1 - 1e-5)
    np.testing.assert_allclose(a_s[ident], np.asarray(st.alpha)[ident],
                               atol=2e-2)
    np.testing.assert_allclose(p_out, np.asarray(st.p_ibd), atol=5e-3)


def test_streaming_pallas_tier_matches_xla(data):
    """numerics="pallas" on a single-device stream runs EVERY chunk pass
    (transfer fold, fused grad stream, posteriors with carries, freq
    fixed point) through the Pallas kernels (interpret mode on CPU); the
    trajectory must match the XLA blocked-linear stream to f32 kernel
    tolerances."""
    gl, dist = data
    S, N = gl.shape[0], gl.shape[1]
    freq0 = np.full(S, 0.2)
    F0 = np.linspace(0.1, 0.6, N)
    a0 = np.linspace(0.02, 0.2, N)
    base = dict(min_iters=2, max_iters=4, min_epsilon=1e-4)

    f_x, F_x, a_x, ll_x, it_x = StreamingEM(gl, dist, chunk_sites=300).run(
        freq0, F0, a0, EMOptions(**base)
    )
    f_p, F_p, a_p, ll_p, it_p = StreamingEM(gl, dist, chunk_sites=300).run(
        freq0, F0, a0, EMOptions(numerics="pallas", **base)
    )
    assert it_p == it_x
    np.testing.assert_allclose(f_p, f_x, atol=1e-4)
    np.testing.assert_allclose(ll_p, ll_x, rtol=1e-5)
    np.testing.assert_allclose(F_p, F_x, atol=1e-3)
    np.testing.assert_allclose(a_p, a_x, atol=1e-3)


def test_streaming_freq_est0_matches_monolithic(data):
    """freq_est=0: the streaming engine skips pass B entirely (its only
    live outputs are the est_maf updates) -- the returned freq must be
    the UNCHANGED input and the (F, alpha) trajectory must still match
    the monolithic engine (ADVICE r3 #3: this gate was untested)."""
    gl, dist = data
    S, N = gl.shape[0], gl.shape[1]
    freq0 = np.full(S, 0.2)
    F0 = np.linspace(0.1, 0.6, N)
    a0 = np.linspace(0.02, 0.2, N)
    opts = EMOptions(freq_est=0, min_iters=3, max_iters=6,
                     min_epsilon=1e-4)

    gl_j = jnp.asarray(gl, jnp.float32)
    dist_j = jnp.asarray(dist, jnp.float32)
    st = init_state(gl_j, jnp.asarray(freq0, jnp.float32),
                    jnp.asarray(F0, jnp.float32),
                    jnp.asarray(a0, jnp.float32))
    for _ in range(3):
        st, _ = em_iteration(gl_j, dist_j, st, block_size="auto",
                             numerics="linear", freq_est=0)

    for numerics in ("linear", "pallas"):
        p_out = np.zeros((S, N))
        se = StreamingEM(gl, dist, chunk_sites=300)
        f_s, F_s, a_s, ll_s, it_s = se.run(
            freq0, F0, a0,
            EMOptions(freq_est=0, min_iters=3, max_iters=3,
                      min_epsilon=1e-4, numerics=numerics),
            p_ibd_out=p_out,
        )
        # unchanged up to the engine's f32 device storage round trip
        np.testing.assert_array_equal(np.float32(f_s), np.float32(freq0))
        np.testing.assert_allclose(ll_s, np.asarray(st.ind_lkl), rtol=2e-5)
        np.testing.assert_allclose(F_s, np.asarray(st.indF), atol=2e-3)
        np.testing.assert_allclose(p_out, np.asarray(st.p_ibd), atol=5e-3)


def test_fused_stream_gradient_matches_oracle(data):
    """The single-stream fused gradient (per-chunk transfer tangents +
    host Fisher-identity assembly) must match the sequential f64 analytic
    gradient, chromosome breaks and ragged chunks included."""
    from ngsf_hmm.models.hmm import loglik_value_and_grad
    from ngsf_hmm.models.streaming import (
        _assemble_chain,
        _grad_from_transfers,
    )
    from ngsf_hmm.ops.emissions import calc_emission

    gl, dist = data
    S, N = gl.shape[0], gl.shape[1]
    freq = np.clip(np.random.default_rng(3).uniform(0.05, 0.45, S), 0, 1)
    F = np.linspace(0.1, 0.8, N)
    a = np.linspace(0.02, 0.4, N)

    e_log = calc_emission(jnp.asarray(gl), jnp.asarray(freq)[:, None])
    ll_o, gF_o, ga_o = loglik_value_and_grad(
        jnp.asarray(F), jnp.asarray(a), e_log, jnp.asarray(dist)
    )

    se = StreamingEM(gl, dist, chunk_sites=300)
    Ts, ss, dTF, dsF, dTa, dsa = se._transfers_grad(freq, F, a)
    v0, wT, ll_f, _ = _assemble_chain(Ts, ss, F)
    gF, ga = _grad_from_transfers(Ts, dTF, dsF, dTa, dsa, v0, wT)

    np.testing.assert_allclose(ll_f, np.asarray(ll_o), rtol=2e-5)
    np.testing.assert_allclose(gF, np.asarray(gF_o), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ga, np.asarray(ga_o), rtol=2e-3, atol=2e-3)


def test_streaming_single_chunk_degenerate(data):
    """chunk_sites >= S: one chunk, still correct."""
    gl, dist = data
    S, N = gl.shape[0], gl.shape[1]
    opts = EMOptions(min_iters=2, max_iters=4, min_epsilon=1e-3)
    se = StreamingEM(gl, dist, chunk_sites=10_000)
    assert se.C == 1
    freq_s, F_s, a_s, ll_s, _ = se.run(
        np.full(S, 0.2), np.full(N, 0.3), np.full(N, 0.05), opts
    )
    assert np.isfinite(ll_s).all()
    assert (freq_s >= 0).all() and (freq_s <= 1).all()


def test_streaming_viterbi_matches_monolithic(data):
    """The chunked max-plus boundary decode reproduces the monolithic
    Viterbi path exactly (both quirk-compat and textbook)."""
    from ngsf_hmm.models.hmm import viterbi
    from ngsf_hmm.models.streaming import StreamingEM, streaming_viterbi
    from ngsf_hmm.ops.emissions import calc_emission

    gl, dist = data
    S, N = gl.shape[0], gl.shape[1]
    freq = np.clip(np.random.default_rng(0).uniform(0.05, 0.45, S), 0, 1)
    F = np.linspace(0.2, 0.7, N)
    a = np.linspace(0.03, 0.3, N)

    e_log = calc_emission(jnp.asarray(gl, jnp.float32),
                          jnp.asarray(freq, jnp.float32)[:, None])
    for compat in (True, False):
        want, _ = viterbi(e_log, jnp.asarray(dist, jnp.float32),
                          jnp.asarray(F, jnp.float32),
                          jnp.asarray(a, jnp.float32), compat=compat)
        se = StreamingEM(gl, dist, chunk_sites=300)
        got = streaming_viterbi(se, freq, F, a, compat=compat)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_streaming_exact_resume(data, tmp_path):
    """Streaming run interrupted at iteration 3 and resumed from the
    (freq, F, alpha) checkpoint finishes identically to an uninterrupted
    run -- emissions regenerate from freq, so the tiny state suffices."""
    from ngsf_hmm.io.checkpoint import (
        load_stream_checkpoint,
        save_stream_checkpoint,
    )

    gl, dist = data
    S, N = gl.shape[0], gl.shape[1]
    freq0 = np.full(S, 0.2)
    F0 = np.linspace(0.1, 0.6, N)
    a0 = np.linspace(0.02, 0.2, N)
    opts = EMOptions(min_iters=3, max_iters=8, min_epsilon=1e-4)
    ck = str(tmp_path / "stream.ckpt.npz")

    se = StreamingEM(gl, dist, chunk_sites=300)
    full = se.run(freq0, F0, a0, opts)

    class Stop(Exception):
        pass

    def cb(n_iter, params, bk):
        save_stream_checkpoint(ck, *params, bk)
        if n_iter == 3:
            raise Stop

    with pytest.raises(Stop):
        se.run(freq0, F0, a0, opts, checkpoint_cb=cb)

    (freq_r, F_r, a_r), bk = load_stream_checkpoint(ck)
    assert bk["n_iter"] == 3
    res = se.run(freq_r, F_r, a_r, opts, resume_bookkeeping=bk)

    assert res[4] == full[4]  # same total iteration count
    for got, want in zip(res[:4], full[:4]):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_streaming_ind_sharded_matches_unsharded(data):
    """Streaming x ind-sharding composition (SURVEY.md §5.8): the same
    streamed run with every chunk sharded over a 5-device ("ind",) mesh
    must reproduce the single-device streamed run (est_maf's cross-ind
    sums become psums; everything else is per-individual)."""
    import jax

    from ngsf_hmm.models.streaming import streaming_viterbi
    from ngsf_hmm.parallel.mesh import make_mesh

    gl, dist = data
    S, N = gl.shape[0], gl.shape[1]
    freq0 = np.full(S, 0.2)
    F0 = np.linspace(0.1, 0.6, N)
    a0 = np.linspace(0.02, 0.2, N)
    opts = EMOptions(min_iters=3, max_iters=6, min_epsilon=1e-4)

    se1 = StreamingEM(gl, dist, chunk_sites=300)
    r1 = se1.run(freq0, F0, a0, opts)

    mesh = make_mesh(1, N, devices=jax.devices()[:N])
    se2 = StreamingEM(gl, dist, chunk_sites=300, mesh=mesh)
    r2 = se2.run(freq0, F0, a0, opts)

    freq1, F1, a1, ll1, it1 = r1
    freq2, F2, a2, ll2, it2 = r2
    assert it2 == it1
    np.testing.assert_allclose(ll2, ll1, rtol=1e-6)
    np.testing.assert_allclose(freq2, freq1, atol=1e-6)
    np.testing.assert_allclose(F2, F1, atol=1e-5)
    # alpha is unidentifiable where F sits on a bound (the likelihood is
    # flat in alpha at F = 0/1; the reference itself prints alpha = NA
    # there, EM.cpp:306-313), so tiny cross-layout float differences can
    # park it anywhere -- compare it only at identifiable rows
    ident = (F1 > 1e-5) & (F1 < 1 - 1e-5)
    np.testing.assert_allclose(a2[ident], a1[ident], atol=1e-5)

    p1 = streaming_viterbi(se1, freq1, F1, a1)
    p2 = streaming_viterbi(se2, freq2, F2, a2)
    np.testing.assert_array_equal(p2, p1)

    with pytest.raises(ValueError, match="not divisible"):
        StreamingEM(gl, dist, chunk_sites=300,
                    mesh=make_mesh(1, 4, devices=jax.devices()[:4]))


def test_streaming_mesh_cli(data, tmp_path, monkeypatch):
    """--stream_chunk + --mesh ind=K from the product surface."""
    import contextlib
    import io
    import os

    from ngsf_hmm.tools.simulate import simulate
    from ngsf_hmm.cli import main

    d = tmp_path
    simulate(n_ind=8, n_sites=400, freq="0.2", site_pos="r", indF="0.4",
             alpha="0.05", depth="2", seed=31, out=str(d / "sim"))
    cwd = os.getcwd()
    buf = io.StringIO()
    args = (
        "--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 8 "
        "--n_sites 400 --freq 0.2 --indF 0.3,0.05 --seed 5 "
        "--min_iters 3 --max_iters 8 --min_epsilon 1e-4 "
        "--stream_chunk 150 "
    )
    try:
        os.chdir(d)
        with contextlib.redirect_stdout(buf):
            rc = main((args + "--mesh ind=8 --out sm").split())
        assert rc == 0
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main((args + "--out s1").split())
        assert rc == 0
    finally:
        os.chdir(cwd)
    assert "ind sharded 8-way" in buf.getvalue()
    # f32 psum reduction order differs across shards and the L-BFGS
    # endpoint amplifies it (same tolerance class as
    # test_streaming_matches_monolithic); non-numeric tokens (path
    # strings, "0.1/0.9" pairs) must match exactly
    def _tok_close(x, y, ext):
        try:
            fx = float(x.replace("NA", "nan"))
            fy = float(y.replace("NA", "nan"))
        except ValueError:
            assert x == y, ext
            return
        np.testing.assert_allclose(fx, fy, rtol=1e-4, atol=2e-3,
                                   err_msg=ext)

    for ext in (".indF", ".ibd"):
        ta = (d / ("sm" + ext)).read_text().split()
        tb = (d / ("s1" + ext)).read_text().split()
        assert len(ta) == len(tb), ext
        for x, y in zip(ta, tb):
            _tok_close(x, y, ext)
    ga = np.fromfile(d / "sm.geno")
    gb = np.fromfile(d / "s1.geno")
    np.testing.assert_allclose(ga, gb, rtol=1e-4, atol=2e-3)


def test_streaming_device_freq_matches_host_path(data):
    """device_freq=True (freq held as the padded [C*cs] f32 device
    vector, sliced on-device per chunk) must reproduce the host-freq
    path EXACTLY: the host path stores the same f32 est_maf outputs
    through a float64 detour, so trajectories are bit-identical."""
    gl, dist = data
    S, N = gl.shape[0], gl.shape[1]
    freq0 = np.full(S, 0.2)
    F0 = np.linspace(0.1, 0.6, N)
    a0 = np.linspace(0.02, 0.2, N)
    opts = EMOptions(min_iters=3, max_iters=6, min_epsilon=1e-4)

    p_a = np.zeros((S, N))
    se_a = StreamingEM(gl, dist, chunk_sites=300, device_freq=False)
    fa, Fa, aa, lla, ita = se_a.run(freq0, F0, a0, opts, p_ibd_out=p_a)

    p_b = np.zeros((S, N))
    se_b = StreamingEM(gl, dist, chunk_sites=300, device_freq=True)
    assert se_b.device_freq
    fb, Fb, ab, llb, itb = se_b.run(freq0, F0, a0, opts, p_ibd_out=p_b)

    assert itb == ita
    np.testing.assert_array_equal(fb, fa)
    np.testing.assert_array_equal(Fb, Fa)
    np.testing.assert_array_equal(ab, aa)
    np.testing.assert_array_equal(llb, lla)
    np.testing.assert_array_equal(p_b, p_a)


def test_streaming_n_rep_sequential_restarts(tmp_path):
    """--stream_chunk + --n_rep runs the ngsF-HMM.sh protocol as
    sequential restarts through one streaming engine: the multi-restart
    outputs must be BYTE-IDENTICAL to the best of the equivalent
    single-replicate runs at seeds seed+r (replicate r re-resolves its
    random inits with GslTaus(seed + r), like stack_restart_states)."""
    import os

    from ngsf_hmm.cli import main
    from ngsf_hmm.tools.simulate import simulate

    d = tmp_path
    simulate(n_ind=6, n_sites=300, freq="0.2", site_pos="r", indF="0.4",
             alpha="0.05", depth="2", seed=31, out=str(d / "sim"))
    base = (
        "--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 6 "
        "--n_sites 300 --freq 0.2 --indF r "
        "--min_iters 3 --max_iters 8 --min_epsilon 1e-4 "
        "--stream_chunk 120 "
    )
    cwd = os.getcwd()
    buf = io.StringIO()
    try:
        os.chdir(d)
        with contextlib.redirect_stdout(buf):
            rc = main((base + "--seed 9 --n_rep 3 --out multi").split())
        assert rc == 0
        tots = []
        for r in range(3):
            with contextlib.redirect_stdout(io.StringIO()):
                rc = main(
                    (base + f"--seed {9 + r} --out rep{r}").split()
                )
            assert rc == 0
            tots.append(float(
                (d / f"rep{r}.indF").read_text().splitlines()[0]
            ))
    finally:
        os.chdir(cwd)
    out = buf.getvalue()
    assert "Replicate 3: logLkl" in out
    best = int(np.argmax(tots))
    for ext in (".indF", ".ibd"):
        assert (d / f"multi{ext}").read_bytes() == (
            d / f"rep{best}{ext}"
        ).read_bytes(), f"{ext} differs from the best single run"
    np.testing.assert_array_equal(
        np.fromfile(d / "multi.geno"), np.fromfile(d / f"rep{best}.geno")
    )


def test_streaming_n_rep_checkpoint_rejected(tmp_path, capsys):
    """--checkpoint + --stream_chunk + --n_rep fails fast through the
    reference-style error path."""
    import os

    from ngsf_hmm.cli import main

    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        with pytest.raises(SystemExit):
            main(
                "--geno x.glf --pos y.gz --n_ind 4 --n_sites 10 --out o "
                "--stream_chunk 5 --n_rep 2 --checkpoint ck.npz".split()
            )
    finally:
        os.chdir(cwd)
    assert "not supported with" in capsys.readouterr().err


def test_streaming_cli_errors_are_reference_style(tmp_path, capsys):
    """Streaming-path failures exit through the reference error() path
    (exit 1 + ERROR banner), not a raw traceback: here n_ind not
    divisible by the mesh ind axis (StreamingEM.__init__ ValueError)."""
    import os

    from ngsf_hmm.cli import main
    from ngsf_hmm.tools.simulate import simulate

    d = tmp_path
    simulate(n_ind=8, n_sites=60, freq="0.2", indF="0.4", alpha="0.05",
             depth="2", seed=3, out=str(d / "sim"))
    cwd = os.getcwd()
    try:
        os.chdir(d)
        with pytest.raises(SystemExit) as ei:
            main(
                "--geno sim.glf.gz --loglkl --pos sim.pos.gz --n_ind 8 "
                "--n_sites 60 --freq 0.2 --indF 0.3,0.05 "
                "--stream_chunk 30 --mesh ind=3 --out bad".split()
            )
    finally:
        os.chdir(cwd)
    assert ei.value.code == 1
    err = capsys.readouterr().err
    assert "ERROR: [EM]" in err and "not divisible" in err


def test_cli_stream_file_matches_preloaded(tmp_path):
    """--stream_file (file-backed GL source + disk-spilled p_ibd/path
    buffers) is byte-equivalent to the preloading --stream_chunk run,
    for gzip-text and raw-binary inputs; --freq e exercises the chunked
    est_maf init."""
    import gzip
    import os

    from ngsf_hmm.cli import main
    from ngsf_hmm.tools.simulate import simulate

    d = tmp_path
    simulate(n_ind=6, n_sites=300, freq="0.2", site_pos="r", indF="0.4",
             alpha="0.03", depth="3", seed=17, out=str(d / "sim"))
    # raw-binary twin holding the SAME log-GL values (no exp/log
    # roundtrip, so outputs can be compared exactly)
    with gzip.open(d / "sim.glf.gz", "rt") as fh:
        raw = np.loadtxt(fh)
    raw.reshape(300, 6, 3).astype("<f8").tofile(d / "sim.bin")

    cwd = os.getcwd()
    try:
        os.chdir(d)
        for geno, tag in (("sim.glf.gz", "txt"), ("sim.bin", "bin")):
            base = (
                f"--geno {geno} --loglkl --pos sim.pos.gz --n_ind 6 "
                "--n_sites 300 --freq e --indF 0.3,0.05 --min_iters 3 "
                "--max_iters 6 --min_epsilon 1e-4 --stream_chunk 90 "
            )
            with contextlib.redirect_stdout(io.StringIO()):
                assert main((base + f"--out mem_{tag}").split()) == 0
            with contextlib.redirect_stdout(io.StringIO()):
                assert main(
                    (base + f"--stream_file --out file_{tag}").split()
                ) == 0
            for ext in (".indF", ".ibd"):
                assert (d / f"file_{tag}{ext}").read_bytes() == \
                    (d / f"mem_{tag}{ext}").read_bytes(), (tag, ext)
            np.testing.assert_array_equal(
                np.fromfile(d / f"file_{tag}.geno"),
                np.fromfile(d / f"mem_{tag}.geno"),
            )
        # text and binary runs see identical values -> identical outputs
        assert (d / "file_txt.indF").read_bytes() == \
            (d / "file_bin.indF").read_bytes()
    finally:
        os.chdir(cwd)


def test_cli_stream_file_requires_stream_chunk():
    from ngsf_hmm.cli import main

    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(SystemExit):
            main("--geno x --pos y --n_ind 2 --n_sites 10 "
                 "--stream_file --out z".split())


def test_slab_caches_bit_identical_and_skip_gl_fetches(data):
    """The budget-gated emission/dist slab caches must be invisible:
    a cached run's full trajectory is BIT-identical to the uncached
    path (the slabs come out of the same jitted math, only memoised),
    and with the cache on, M-step line-search evals must not touch the
    chunk source at all (for --stream_file that is a disk read per
    chunk per eval)."""
    import os

    gl, dist = data
    S, N = gl.shape[0], gl.shape[1]
    opts = EMOptions(min_iters=3, max_iters=6, min_epsilon=1e-6)

    class Counting(StreamingEM):
        fetches = 0

        def _chunk(self, c):
            Counting.fetches += 1
            return super()._chunk(c)

    def run(cache_bytes):
        old = os.environ.get("NGSF_STREAM_CACHE_BYTES")
        os.environ["NGSF_STREAM_CACHE_BYTES"] = cache_bytes
        try:
            Counting.fetches = 0
            se = Counting(gl, dist, chunk_sites=300)
            out = se.run(np.full(S, 0.2), np.full(N, 0.2),
                         np.full(N, 0.05), opts)
            return se, out, Counting.fetches
        finally:
            if old is None:
                del os.environ["NGSF_STREAM_CACHE_BYTES"]
            else:
                os.environ["NGSF_STREAM_CACHE_BYTES"] = old

    se_on, out_on, fetch_on = run(str(1 << 30))
    assert se_on._cache_e and se_on._cache_d
    se_off, out_off, fetch_off = run("0")
    assert not se_off._cache_e and not se_off._cache_d

    for a, b in zip(out_on, out_off):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # cached: pass A (slab build) + pass B (est_maf needs raw GLs) per
    # chunk per iteration -- every M-step eval is slab-fed, and the
    # final posterior pass reuses the last iteration's still-warm slabs
    # (it runs at the pre-update freq, which is that epoch's cache key)
    n_iter = out_on[4]
    assert fetch_on == se_on.C * 2 * n_iter
    assert fetch_off > fetch_on * 2  # the evals were real fetches before


def test_streaming_slab_maf_matches_xla_stream():
    """N >= 32 single-device fused stream: pass B's freq fixed point
    runs the v2 SLAB est_maf kernel (no raw-gl fetch at all) -- the
    trajectory must match the XLA stream to macro-tier tolerances."""
    rng = np.random.default_rng(57)
    S, N = 700, 40
    depth = rng.poisson(2.0, (S, N))
    truth = rng.integers(0, 3, (S, N))
    err = 0.05
    p_der = np.array([err, 0.5, 1 - err])[truth]
    der = np.clip(rng.binomial(depth, p_der), 0, depth)
    ll = np.stack([
        der * np.log(p) + (depth - der) * np.log1p(-p)
        for p in (err, 0.5, 1 - err)
    ], -1)
    ll = np.where(depth[..., None] == 0, 0.0, ll)
    gl = ll - ll.max(-1, keepdims=True)
    gl = np.log(np.exp(gl) / np.exp(gl).sum(-1, keepdims=True))
    dist = np.full(S, 1e-5)
    freq0 = np.full(S, 0.2)
    F0 = np.linspace(0.1, 0.6, N)
    a0 = np.linspace(0.02, 0.2, N)
    base = dict(min_iters=2, max_iters=3, min_epsilon=1e-4)

    f_x, F_x, a_x, ll_x, it_x = StreamingEM(gl, dist, chunk_sites=256).run(
        freq0, F0, a0, EMOptions(**base)
    )
    f_p, F_p, a_p, ll_p, it_p = StreamingEM(gl, dist, chunk_sites=256).run(
        freq0, F0, a0, EMOptions(numerics="pallas", **base)
    )
    assert it_p == it_x
    np.testing.assert_allclose(f_p, f_x, atol=2e-4)
    np.testing.assert_allclose(ll_p, ll_x, rtol=2e-5)
    np.testing.assert_allclose(F_p, F_x, atol=1e-3)


def test_partial_slab_pinning_matches_uncached(data):
    """A budget that fits only SOME chunks' slabs pins a fixed prefix
    (never-evicted) instead of disabling the cache -- trajectory still
    bit-identical to the uncached path."""
    import os

    gl, dist = data
    S, N = gl.shape[0], gl.shape[1]
    opts = EMOptions(min_iters=2, max_iters=4, min_epsilon=1e-6)

    probe = StreamingEM(gl, dist, chunk_sites=300)
    probe._config_kernel(opts)
    e_b, _ = probe._slab_bytes()

    def run(cache_bytes):
        old = os.environ.get("NGSF_STREAM_CACHE_BYTES")
        os.environ["NGSF_STREAM_CACHE_BYTES"] = cache_bytes
        try:
            se = StreamingEM(gl, dist, chunk_sites=300)
            out = se.run(np.full(S, 0.2), np.full(N, 0.2),
                         np.full(N, 0.05), opts)
            return se, out
        finally:
            if old is None:
                del os.environ["NGSF_STREAM_CACHE_BYTES"]
            else:
                os.environ["NGSF_STREAM_CACHE_BYTES"] = old

    se_pin, out_pin = run(str(int(e_b * 1.5)))
    assert se_pin._cache_e and se_pin._pin_k == 1 and not se_pin._cache_d
    se_off, out_off = run("0")
    assert not se_off._cache_e
    for a, b in zip(out_pin, out_off):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
