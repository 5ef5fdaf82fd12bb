"""Multi-host substrate (parallel/distributed.py): a real 2-process run.

Spawns two CLI processes joined through jax.distributed (gloo CPU
collectives, 4 virtual devices each -> one 8-device global mesh) and
checks the full run -- slab loading, sharded EM to convergence, sharded
Viterbi, process-0-only writers -- against the single-process engine on
the same inputs.  This is the dryrun SURVEY.md §5.8 calls for: the same
program scales to multi-host GPU clusters by changing only --coordinator /
--n_procs / --proc_id.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sim(tmp_path):
    from ngsf_hmm.tools.simulate import simulate

    out = tmp_path / "sim"
    simulate(n_ind=8, n_sites=200, freq="0.25", site_pos="r", indF="0.3",
             alpha="0.05", seed=29, out=str(out), depth="4")
    return out


def _cli_args(sim, out, extra, n_sites=200, mesh="ind=8"):
    return [
        sys.executable, "-m", "ngsf_hmm",
        "--geno", f"{sim}.glf.gz", "--loglkl", "--pos", f"{sim}.pos.gz",
        "--n_ind", "8", "--n_sites", str(n_sites), "--freq", "0.2",
        "--indF", "0.2,0.05", "--seed", "7", "--min_iters", "5",
        "--max_iters", "20", "--min_epsilon", "1e-6",
        "--device", "cpu", "--mesh", mesh, "--out", str(out),
    ] + extra


def _env(n_local_devices):
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_local_devices}"
    )
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["NGSF_NO_NATIVE"] = env.get("NGSF_NO_NATIVE", "0")
    return env


def test_two_process_run_matches_single(tmp_path):
    sim = _sim(tmp_path)

    # single-process baseline on the same 8-wide ind mesh
    r = subprocess.run(
        _cli_args(sim, tmp_path / "single", []),
        env=_env(8), capture_output=True, text=True, timeout=420,
    )
    assert r.returncode == 0, r.stdout + r.stderr

    port = _free_port()
    procs = [
        subprocess.Popen(
            _cli_args(sim, tmp_path / "multi", [
                "--coordinator", f"localhost:{port}",
                "--n_procs", "2", "--proc_id", str(pid),
            ]),
            env=_env(4), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for pr in procs:
        try:
            out, err = pr.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((pr.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, out + err

    # process 1 stays silent and writes nothing; process 0 writes all
    # (gloo itself prints connection chatter on stdout -- not ours)
    assert "Done!" in outs[0][1]
    p1_lines = [
        ln for ln in outs[1][1].splitlines()
        if ln.strip() and "[Gloo]" not in ln and "peer ranks" not in ln
    ]
    assert p1_lines == []

    for ext in (".indF", ".ibd"):
        single = (tmp_path / "single").with_suffix(ext).read_text()
        multi = (tmp_path / "multi").with_suffix(ext).read_text()
        ts, tm = single.split(), multi.split()
        assert len(ts) == len(tm), ext
        for x, y in zip(ts, tm):
            try:
                fx = float(x.replace("NA", "nan"))
                fy = float(y.replace("NA", "nan"))
            except ValueError:
                assert x == y, ext  # non-numeric tokens (path strings)
                continue
            # the 2-process run sums est_maf accumulators in a
            # different order than the single-process mesh; f64
            # reduction noise amplified through the EM + L-BFGS
            # trajectory bounds agreement at ~1e-6, not ulp
            np.testing.assert_allclose(fy, fx, rtol=2e-6, atol=1e-8,
                                       err_msg=ext)
    g_s = np.fromfile(tmp_path / "single.geno")
    g_m = np.fromfile(tmp_path / "multi.geno")
    np.testing.assert_allclose(g_m, g_s, rtol=2e-6, atol=1e-8)


def test_axis_slab_and_global_from_slab():
    """axis_slab on a single-process sharding covers the full axis."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ngsf_hmm.parallel.distributed import axis_slab, host_array
    from ngsf_hmm.parallel.mesh import make_mesh

    mesh = make_mesh(1, 8)
    sh = NamedSharding(mesh, P(None, "ind", None))
    off, cnt = axis_slab(sh, (16, 8, 3), 1)
    assert (off, cnt) == (0, 8)
    x = np.arange(16 * 8 * 3, dtype=np.float64).reshape(16, 8, 3)
    g = jax.device_put(x, sh)
    np.testing.assert_array_equal(host_array(g), x)


def _compare_outputs(a, b, rtol=2e-6, atol=1e-8):
    for ext in (".indF", ".ibd"):
        ts = pathlib.Path(str(a) + ext).read_text().split()
        tm = pathlib.Path(str(b) + ext).read_text().split()
        assert len(ts) == len(tm), ext
        for x, y in zip(ts, tm):
            try:
                fx = float(x.replace("NA", "nan"))
                fy = float(y.replace("NA", "nan"))
            except ValueError:
                assert x == y, ext
                continue
            np.testing.assert_allclose(fy, fx, rtol=rtol, atol=atol,
                                       err_msg=ext)
    g_a = np.fromfile(str(a) + ".geno")
    g_b = np.fromfile(str(b) + ".geno")
    np.testing.assert_allclose(g_b, g_a, rtol=rtol, atol=atol)


def test_two_process_site_mesh_matches_single(tmp_path):
    """Site-sharded meshes across processes: 2 gloo CPU processes x 4
    virtual devices run an 8-way SITE mesh (boundary-carry all_gather
    over DCN, per-host (site,) slab loading, pad sites on the last
    shard: 198 sites pad to 200) and must match the same site mesh run
    in one process."""
    from ngsf_hmm.tools.simulate import simulate

    sim = tmp_path / "sim"
    simulate(n_ind=8, n_sites=198, freq="0.25", site_pos="r", indF="0.3",
             alpha="0.05", seed=31, out=str(sim), depth="4")

    r = subprocess.run(
        _cli_args(sim, tmp_path / "single", [], n_sites=198,
                  mesh="site=8"),
        env=_env(8), capture_output=True, text=True, timeout=420,
    )
    assert r.returncode == 0, r.stdout + r.stderr

    port = _free_port()
    # small gather chunks: the .geno writer must stream multiple chunked
    # allgathers (incl. the clamped last window over the 2 pad sites)
    env_c = _env(4)
    env_c["NGSF_GENO_GATHER_CHUNK"] = "64"
    procs = [
        subprocess.Popen(
            _cli_args(sim, tmp_path / "multi", [
                "--coordinator", f"localhost:{port}",
                "--n_procs", "2", "--proc_id", str(pid),
            ], n_sites=198, mesh="site=8"),
            env=env_c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for pr in procs:
        try:
            out, err = pr.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((pr.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, out + err
    assert "Done!" in outs[0][1]

    _compare_outputs(tmp_path / "single", tmp_path / "multi")


def test_two_process_grid_mesh_matches_single(tmp_path):
    """The 2-D (ind=2, site=4) grid mesh across 2 processes: each host
    owns an (ind, site) rectangle of the GL matrix."""
    sim = _sim(tmp_path)

    r = subprocess.run(
        _cli_args(sim, tmp_path / "single", [], mesh="ind=2,site=4"),
        env=_env(8), capture_output=True, text=True, timeout=420,
    )
    assert r.returncode == 0, r.stdout + r.stderr

    port = _free_port()
    procs = [
        subprocess.Popen(
            _cli_args(sim, tmp_path / "multi", [
                "--coordinator", f"localhost:{port}",
                "--n_procs", "2", "--proc_id", str(pid),
            ], mesh="ind=2,site=4"),
            env=_env(4), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for pr in procs:
        try:
            out, err = pr.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((pr.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, out + err

    _compare_outputs(tmp_path / "single", tmp_path / "multi")


def _run2(sim, out, extra, tmo=400):
    port = _free_port()
    procs = [
        subprocess.Popen(
            _cli_args(sim, out, [
                "--coordinator", f"localhost:{port}",
                "--n_procs", "2", "--proc_id", str(pid),
            ] + extra, n_sites=198, mesh="site=8"),
            env=_env(4), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for pr in procs:
        try:
            outs.append(pr.communicate(timeout=tmo))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for pr, (out_, err) in zip(procs, outs):
        assert pr.returncode == 0, out_ + err


def test_two_process_site_mesh_checkpoint_resume(tmp_path):
    """Checkpoint/resume across a 2-process site mesh: checkpoints store
    the gathered UNPADDED host state (process 0 only); a resumed run
    re-pads and re-shards it onto the global mesh and must land exactly
    where an uninterrupted run does."""
    from ngsf_hmm.tools.simulate import simulate

    sim = tmp_path / "sim"
    simulate(n_ind=8, n_sites=198, freq="0.25", site_pos="r", indF="0.3",
             alpha="0.05", seed=31, out=str(sim), depth="4")

    _run2(sim, tmp_path / "full",
          ["--min_iters", "12", "--max_iters", "13", "--min_epsilon", "100"])
    ck = str(tmp_path / "ck.npz")
    _run2(sim, tmp_path / "part",
          ["--min_iters", "5", "--max_iters", "6", "--min_epsilon", "100",
           "--checkpoint", ck])
    _run2(sim, tmp_path / "res",
          ["--min_iters", "12", "--max_iters", "13", "--min_epsilon", "100",
           "--checkpoint", ck, "--resume"])

    ta = (tmp_path / "full.indF").read_text().split()
    tb = (tmp_path / "res.indF").read_text().split()
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        try:
            fx = float(x.replace("NA", "nan"))
            fy = float(y.replace("NA", "nan"))
        except ValueError:
            assert x == y
            continue
        np.testing.assert_allclose(fy, fx, rtol=1e-6, atol=1e-9,
                                   equal_nan=True)


def test_two_process_streaming_matches_single(tmp_path):
    """Multi-host STREAMING: --coordinator + --mesh ind=8 +
    --stream_chunk + --stream_file across 2 gloo processes x 4 virtual
    devices. Each process streams only its ind columns of every chunk
    from the input file (ChunkedGLSource ind_slab); est_maf's
    cross-individual sums psum over the global mesh; the host L-BFGS
    runs per-local-individual; .ibd is stitched from per-process row
    part-files. Must match the single-process --stream_file run, incl.
    the chunked --freq e init and a streaming checkpoint save."""
    sim = _sim(tmp_path)
    extra = ["--stream_chunk", "60", "--stream_file", "--freq", "e"]

    r = subprocess.run(
        _cli_args(sim, tmp_path / "single", extra),
        env=_env(8), capture_output=True, text=True, timeout=420,
    )
    assert r.returncode == 0, r.stdout + r.stderr

    port = _free_port()
    ck = str(tmp_path / "stream.ck")
    procs = [
        subprocess.Popen(
            _cli_args(sim, tmp_path / "multi", [
                "--coordinator", f"localhost:{port}",
                "--n_procs", "2", "--proc_id", str(pid),
                "--checkpoint", ck,
            ] + extra),
            env=_env(4), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for pr in procs:
        try:
            outs.append(pr.communicate(timeout=420))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for pr, (out_, err) in zip(procs, outs):
        assert pr.returncode == 0, out_ + err
    assert "Done!" in outs[0][0]
    assert "across 2 processes" in outs[0][0]

    # f32 psum reduction order differs between 1- and 2-process meshes;
    # same tolerance class as the other distributed legs
    _compare_outputs(tmp_path / "single", tmp_path / "multi",
                     rtol=1e-4, atol=2e-3)
    # no stray part files; checkpoint holds the GLOBAL param vectors
    assert not list(tmp_path.glob("multi.ibd.part*"))
    from ngsf_hmm.io.checkpoint import load_stream_checkpoint

    (fq, iF, al), bk = load_stream_checkpoint(ck)
    assert fq.shape == (200,) and iF.shape == (8,) and al.shape == (8,)
    assert int(bk["n_iter"]) >= 5
