"""Tools: convert_ibd (vs the reference perl script as oracle) and the
IBD plotter (smoke: produces a valid multi-page PDF from real .ibd
output)."""

import gzip
import io
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from ngsf_hmm.tools.convert_ibd import (
    bed_to_pos,
    pos_to_bed,
    read_inds,
    read_sites,
)

REF_PL = pathlib.Path("/root/reference/scripts/convert_ibd.pl")


@pytest.fixture()
def fixture_files(tmp_path):
    rng = np.random.default_rng(3)
    n_ind, n_sites = 4, 60
    chroms = ["chr1"] * 40 + ["chr2"] * 20
    pos = np.concatenate(
        [np.sort(rng.choice(np.arange(1, 10_000), 40, replace=False)),
         np.sort(rng.choice(np.arange(1, 5_000), 20, replace=False))]
    )
    (tmp_path / "sim.pos").write_text(
        "".join(f"{c}\t{p}\n" for c, p in zip(chroms, pos))
    )
    (tmp_path / "sim.ind").write_text(
        "".join(f"ind_{i}\n" for i in range(n_ind))
    )
    paths = (rng.random((n_ind, n_sites)) < 0.35).astype(int)
    # make a run crossing the chromosome boundary to exercise the split
    paths[0, 38:43] = 1
    lkl_line = "//\t" + "\t".join("-1.0" for _ in range(n_ind))
    ibd = lkl_line + "\n" + "".join(
        "".join(map(str, row)) + "\n" for row in paths
    )
    # posterior rows follow in a real .ibd file; they must be ignored
    ibd += "".join("\t".join("0.5" for _ in range(n_sites)) + "\n"
                   for _ in range(n_ind))
    (tmp_path / "run.ibd").write_text(ibd)
    return tmp_path, n_ind, n_sites


def _run_perl(tmp, args):
    r = subprocess.run(
        ["perl", str(REF_PL)] + args, cwd=tmp, capture_output=True, text=True
    )
    assert r.returncode == 0, r.stderr
    return r.stdout


@pytest.mark.skipif(not REF_PL.exists(), reason="reference script missing")
def test_pos_to_bed_matches_perl(fixture_files):
    tmp, n_ind, n_sites = fixture_files
    want = _run_perl(
        tmp, ["--ind", "sim.ind", "--pos", "sim.pos", "--ibd_pos", "run.ibd"]
    )
    sites = read_sites(str(tmp / "sim.pos"))
    inds = read_inds(str(tmp / "sim.ind"))
    out = io.StringIO()
    pos_to_bed(sites, inds, str(tmp / "run.ibd"), out)
    assert out.getvalue() == want


@pytest.mark.skipif(not REF_PL.exists(), reason="reference script missing")
def test_bed_roundtrip_matches_perl(fixture_files):
    tmp, n_ind, n_sites = fixture_files
    bed = _run_perl(
        tmp, ["--ind", "sim.ind", "--pos", "sim.pos", "--ibd_pos", "run.ibd"]
    )
    (tmp / "run.bed").write_text(bed)
    want = _run_perl(
        tmp, ["--ind", "sim.ind", "--pos", "sim.pos", "--ibd_bed", "run.bed"]
    )
    sites = read_sites(str(tmp / "sim.pos"))
    inds = read_inds(str(tmp / "sim.ind"))
    out = io.StringIO()
    bed_to_pos(sites, inds, str(tmp / "run.bed"), out)
    assert out.getvalue() == want
    # and the round trip reproduces the original 0/1 rows
    orig = [
        ln for ln in (tmp / "run.ibd").read_text().splitlines()[1:]
        if "\t" not in ln
    ][:n_ind]
    got = out.getvalue().splitlines()
    assert got == orig


def test_star_applies_to_all(fixture_files):
    tmp, n_ind, n_sites = fixture_files
    sites = read_sites(str(tmp / "sim.pos"))
    inds = read_inds(str(tmp / "sim.ind"))
    chrom, p = sites[5]
    (tmp / "star.bed").write_text(f"{chrom}\t{p - 1}\t{p}\t*\n")
    out = io.StringIO()
    bed_to_pos(sites, inds, str(tmp / "star.bed"), out)
    rows = out.getvalue().splitlines()
    assert all(r[5] == "1" for r in rows)
    assert all(r.count("1") == 1 for r in rows)


def test_plotter_smoke(fixture_files):
    tmp, n_ind, n_sites = fixture_files
    from ngsf_hmm.tools.plot_ibd import main

    rc = main([
        "--in_file", str(tmp / "run.ibd"), "--n_ind", str(n_ind),
        "--n_sites", str(n_sites), "--pos", str(tmp / "sim.pos"),
        "--marg_prob", "--plot_sites", "--out", str(tmp / "out.pdf"),
    ])
    assert rc == 0
    head = (tmp / "out.pdf").read_bytes()[:5]
    assert head == b"%PDF-"
    # 2 chromosomes -> at least 2 pages
    assert (tmp / "out.pdf").read_bytes().count(b"/Type /Page") >= 2


def test_cli_short_options_parse_like_getopt():
    """glibc getopt_long_only: single-dash single-char tokens that are
    valid short options are SHORT options (-s = n_sites, -n = n_ind), not
    long-prefix matches (-s must not become --seed); bundling (-lL,
    -IA) and glued args (-s1000) work; '--se' still prefix-matches
    --seed (reference optstring parse_args.cpp:71)."""
    from ngsf_hmm.cli import parse_args

    p = parse_args("-n 20 -s 1000 -S 7".split())
    assert p["n_ind"] == 20
    assert p["n_sites"] == 1000
    assert p["seed"] == 7

    p = parse_args("-s1000 -lL -IA".split())
    assert p["n_sites"] == 1000
    assert p["lkl"] and p["loglkl"]
    assert p["indF_fixed"] and p["alpha_fixed"]

    p = parse_args("--se 42 -m 3 -M 9".split())
    assert p["seed"] == 42
    assert p["min_iters"] == 3
    assert p["max_iters"] == 9


def test_simulate_binary_round_trips_through_the_readers(tmp_path):
    """The vectorised simulator writes the reference's binary GL layout
    and a position file the CLI's readers accept; its IBD chain has the
    stationary share F."""
    from ngsf_hmm.io.readers import read_geno, read_pos_dist, sniff_binary
    from ngsf_hmm.tools.simulate import simulate_binary

    out = str(tmp_path / "sim")
    N, S = 6, 4000
    path = simulate_binary(N, S, out, indF=0.4, alpha=0.5, seed=3)
    assert path.shape == (N, S) and set(np.unique(path)) <= {0, 1}
    assert abs(path.mean() - 0.4) < 0.1
    assert sniff_binary(out + ".glf", N, S)
    gl = read_geno(out + ".glf", N, S, binary=True)
    assert gl.shape == (S, N, 3) and np.all(np.isfinite(gl))
    np.testing.assert_allclose(np.exp(gl).sum(-1), 1.0, rtol=1e-12)
    dist = read_pos_dist(out + ".pos.gz", S)
    assert dist.shape == (S,) and np.all(dist[1:] >= 1)


def test_synth_device_gls_are_normalised_and_seeded():
    from ngsf_hmm.tools.simulate import synth_device

    gl, dist = synth_device(500, 7, seed=5)
    gl2, _ = synth_device(500, 7, seed=5)
    assert gl.shape == (500, 7, 3) and dist.shape == (500,)
    np.testing.assert_allclose(np.exp(np.asarray(gl, np.float64)).sum(-1),
                               1.0, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(gl), np.asarray(gl2))
    assert np.all(np.asarray(dist) > 0)
