"""Native IO core (native/ngsf_io.cpp) vs the NumPy oracle readers.

Every format x option combination must match the pure-NumPy readers to
1-2 ULP (libm vs NumPy SIMD exp/log differ in the last bit), and error
cases must raise the same messages."""

import gzip
import os

import numpy as np
import pytest

from ngsf_hmm.io import native, readers


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no compiler?)"
)


@pytest.fixture(autouse=True)
def _force_oracle_for_reference(monkeypatch):
    """Make readers.* use the pure-NumPy path inside this module so we can
    compare against it explicitly."""
    monkeypatch.setattr(native, "available", lambda: False)
    yield
    monkeypatch.setattr(native, "available", lambda: True)


RNG = np.random.default_rng(11)


def _write_text(path, rows, gz=True):
    op = gzip.open if gz else open
    with op(path, "wt") as fh:
        for r in rows:
            fh.write(r + "\n")


def test_binary_parity(tmp_path):
    S, N = 40, 5
    gl = RNG.random((S, N, 3)) + 1e-6
    p = tmp_path / "g.bin"
    gl.astype("<f8").tofile(p)
    a = readers.read_geno(str(p), N, S, binary=True)
    b = native.read_geno_binary(str(p), N, S, log_scale=False)
    np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-14)

    logp = tmp_path / "g.log.bin"
    np.log(gl).astype("<f8").tofile(logp)
    a = readers.read_geno(str(logp), N, S, binary=True, log_scale=True)
    b = native.read_geno_binary(str(logp), N, S, log_scale=True)
    np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-14)


def test_binary_zero_likelihood_conv_space(tmp_path):
    S, N = 4, 2
    gl = RNG.random((S, N, 3))
    gl[1, 0, 2] = 0.0  # log -> -inf -> -BIG (read_data.cpp conv_space)
    p = tmp_path / "z.bin"
    gl.astype("<f8").tofile(p)
    a = readers.read_geno(str(p), N, S, binary=True)
    b = native.read_geno_binary(str(p), N, S, log_scale=False)
    np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-14)


def test_text_probs_parity(tmp_path):
    S, N = 30, 4
    gl = RNG.random((S, N, 3)) + 1e-6
    # beagle-ish: marker + allele columns, then values
    rows = [
        "marker\tallele1\tallele2\t" + "\t".join(
            f"Ind{i}" for i in range(N * 3))
    ]
    for s in range(S):
        rows.append(
            f"chr1_{s + 1}\t0\t1\t" + "\t".join(f"{x:.6f}" for x in gl[s].ravel())
        )
    p = tmp_path / "b.gz"
    _write_text(p, rows)
    a = readers.read_geno(str(p), N, S, probs=True)
    b = native.read_geno_text(str(p), N, S, probs=True, log_scale=False)
    np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-14)


def test_text_loglkl_parity(tmp_path):
    S, N = 25, 3
    gl = np.log(RNG.random((S, N, 3)) + 1e-6)
    rows = ["\t".join(f"{x:.8f}" for x in gl[s].ravel()) for s in range(S)]
    p = tmp_path / "l.gz"
    _write_text(p, rows)
    a = readers.read_geno(str(p), N, S, probs=True, log_scale=True)
    b = native.read_geno_text(str(p), N, S, probs=True, log_scale=True)
    np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-14)


def test_text_called_genotypes_parity(tmp_path):
    S, N = 30, 6
    g = RNG.integers(-1, 3, size=(S, N))
    rows = ["\t".join(str(x) for x in g[s]) for s in range(S)]
    p = tmp_path / "tg.gz"
    _write_text(p, rows)
    a = readers.read_geno(str(p), N, S)
    b = native.read_geno_text(str(p), N, S, probs=False, log_scale=False)
    np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-14)


def test_binary_slab_parity(tmp_path):
    """Slab reads (multi-host loading) must equal the full read sliced,
    for every corner: interior slab, full-width, full-height, 1x1."""
    S, N = 37, 6
    gl = RNG.random((S, N, 3)) + 1e-6
    p = tmp_path / "slab.bin"
    gl.astype("<f8").tofile(p)
    full = native.read_geno_binary(str(p), N, S, log_scale=False)
    for (so, sc, io_, ic) in [(5, 11, 2, 3), (0, S, 1, 4), (10, 7, 0, N),
                              (S - 1, 1, N - 1, 1), (0, S, 0, N)]:
        slab = native.read_geno_binary_slab(
            str(p), N, S, False, so, sc, io_, ic)
        np.testing.assert_array_equal(slab, full[so:so + sc, io_:io_ + ic])
    with pytest.raises(ValueError, match="slab out of range"):
        native.read_geno_binary_slab(str(p), N, S, False, 30, 10, 0, N)
    # wrong n_sites: the whole-file size check fires even for a tiny slab
    with pytest.raises(ValueError, match="invalid/corrupt"):
        native.read_geno_binary_slab(str(p), N, S + 1, False, 0, 1, 0, 1)


def test_text_slab_parity(tmp_path):
    S, N = 29, 4
    gl = RNG.random((S, N, 3)) + 1e-6
    rows = ["marker\tallele1\tallele2\t" + "\t".join(
        f"Ind{i}" for i in range(N * 3))]
    for s in range(S):
        rows.append(f"chr1_{s + 1}\t0\t1\t"
                    + "\t".join(f"{x:.6f}" for x in gl[s].ravel()))
    p = tmp_path / "slab.gz"
    _write_text(p, rows)
    full = native.read_geno_text(str(p), N, S, probs=True, log_scale=False)
    for (so, sc, io_, ic) in [(3, 9, 1, 2), (0, S, 0, N), (S - 4, 4, 2, 2)]:
        slab = native.read_geno_text_slab(
            str(p), N, S, True, False, so, sc, io_, ic)
        np.testing.assert_array_equal(slab, full[so:so + sc, io_:io_ + ic])
    # called-genotype flavour too
    g = RNG.integers(-1, 3, size=(S, N))
    q = tmp_path / "slabg.gz"
    _write_text(q, ["\t".join(str(x) for x in g[s]) for s in range(S)])
    fullg = native.read_geno_text(str(q), N, S, probs=False, log_scale=False)
    slabg = native.read_geno_text_slab(
        str(q), N, S, False, False, 7, 12, 1, 2)
    np.testing.assert_array_equal(slabg, fullg[7:19, 1:3])
    # tail-owning slab still detects a short file
    with pytest.raises(ValueError, match="premature EOF"):
        native.read_geno_text_slab(
            str(q), N, S + 3, False, False, S, 3, 0, N)


def test_read_geno_slab_dispatch(tmp_path):
    """readers.read_geno_slab: NumPy fallback slice == native slab."""
    S, N = 16, 3
    gl = RNG.random((S, N, 3)) + 1e-6
    p = tmp_path / "d.bin"
    gl.astype("<f8").tofile(p)
    a = readers.read_geno_slab(str(p), N, S, (4, 8), (1, 2), binary=True)
    b = native.read_geno_binary_slab(str(p), N, S, False, 4, 8, 1, 2)
    np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-14)


def test_pos_parity(tmp_path):
    rows = ["chr\tpos"]  # header (pos field parses to 0? no -> non-numeric)
    pos = np.sort(RNG.choice(np.arange(1, 10_000), 20, replace=False))
    rows += [f"chr1\t{p}" for p in pos[:12]] + [f"chr2\t{p}" for p in pos[12:]]
    p = tmp_path / "p.gz"
    _write_text(p, rows)
    a = readers.read_pos_dist(str(p), 20)
    b = native.read_pos_dist(str(p), 20)
    np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-14)
    assert np.isinf(b[12])


def test_error_parity(tmp_path):
    S, N = 5, 2
    rows = ["\t".join("0.5" for _ in range(N * 3 - 1))]  # too few fields... header skip; then EOF
    p = tmp_path / "bad.gz"
    _write_text(p, rows)
    with pytest.raises(ValueError, match="premature EOF"):
        native.read_geno_text(str(p), N, S, probs=True, log_scale=False)

    g = tmp_path / "badgeno.gz"
    _write_text(g, ["0\t3"])
    with pytest.raises(ValueError, match="coded as"):
        native.read_geno_text(str(g), 2, 1, probs=False, log_scale=False)

    bad = tmp_path / "trunc.bin"
    np.zeros(5).tofile(bad)
    with pytest.raises(ValueError, match="invalid/corrupt"):
        native.read_geno_binary(str(bad), N, S, log_scale=False)


def test_plain_text_not_gz(tmp_path):
    """zlib transparently reads uncompressed files (gen_func.cpp:208-223)."""
    S, N = 3, 2
    gl = RNG.random((S, N, 3))
    rows = ["\t".join(f"{x:.6f}" for x in gl[s].ravel()) for s in range(S)]
    p = tmp_path / "plain.txt"
    _write_text(p, rows, gz=False)
    a = readers.read_geno(str(p), N, S, probs=True)
    b = native.read_geno_text(str(p), N, S, probs=True, log_scale=False)
    np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-14)
