"""ChunkedGLSource (io/glsource.py): file-backed chunks must equal the
monolithic read pipeline exactly, for binary and gzip-text inputs, with
ind slabs and the processed-chunk cache."""

import gzip

import numpy as np
import jax.numpy as jnp
import pytest

from ngsf_hmm.io import readers
from ngsf_hmm.io.glsource import ChunkedGLSource, est_maf_streamed
from ngsf_hmm.ops.hwe import call_geno as call_geno_op
from ngsf_hmm.ops.hwe import post_prob

RNG = np.random.default_rng(5)
S, N = 60, 5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("glsrc")
    gl = RNG.random((S, N, 3)) + 1e-6
    binp = d / "g.bin"
    gl.astype("<f8").tofile(binp)
    txtp = d / "g.glf.gz"
    with gzip.open(txtp, "wt") as fh:
        for row in gl.reshape(S, N * 3):
            fh.write(" ".join(f"{v:.10g}" for v in row) + "\n")
    return d, gl


def _monolithic(path, binary, call_geno=False):
    gl = readers.read_geno(str(path), N, S, binary=binary, probs=True)
    g = jnp.asarray(gl)
    if call_geno:
        g = call_geno_op(g)
    return np.asarray(post_prob(g, None), np.float64)


@pytest.mark.parametrize("kind", ["bin", "txt"])
def test_source_equals_monolithic_pipeline(files, kind, tmp_path):
    d, _ = files
    path = d / ("g.bin" if kind == "bin" else "g.glf.gz")
    want = _monolithic(path, kind == "bin")
    src = ChunkedGLSource(str(path), N, S, binary=kind == "bin",
                          probs=True, cache_dir=str(tmp_path))
    got = np.concatenate([src[0:17], src[17:40], src[40:S]])
    np.testing.assert_array_equal(got, want)
    # second reads come from the cache and must be identical
    np.testing.assert_array_equal(src[0:17], want[0:17])
    np.testing.assert_array_equal(src[5:25], want[5:25])  # straddles


def test_source_ind_slab(files):
    d, _ = files
    for kind, path in (("bin", d / "g.bin"), ("txt", d / "g.glf.gz")):
        # each format against ITS OWN monolithic read (the %.10g text
        # round-trip perturbs every value relative to the raw doubles)
        want = _monolithic(path, kind == "bin")
        src = ChunkedGLSource(str(path), N, S, binary=kind == "bin",
                              probs=True, ind_slab=(1, 3))
        assert src.shape == (S, 3, 3)
        np.testing.assert_array_equal(src[10:30], want[10:30, 1:4])


def test_source_call_geno(files):
    d, _ = files
    want = _monolithic(d / "g.bin", True, call_geno=True)
    src = ChunkedGLSource(str(d / "g.bin"), N, S, binary=True, probs=True,
                          call_geno=True)
    np.testing.assert_array_equal(src[0:S], want)


def test_est_maf_streamed_matches_monolithic(files):
    from ngsf_hmm.ops.maf import est_maf

    d, _ = files
    src = ChunkedGLSource(str(d / "g.bin"), N, S, binary=True, probs=True)
    g = jnp.asarray(src[0:S])
    want = np.asarray(est_maf(g, jnp.zeros((S, N), g.dtype)))
    got = est_maf_streamed(src, chunk_sites=13)
    np.testing.assert_array_equal(got, want)


def test_source_rejects_bad_sizes_and_slices(files, tmp_path):
    d, _ = files
    with pytest.raises(ValueError, match="invalid/corrupt"):
        ChunkedGLSource(str(d / "g.bin"), N, S + 1, binary=True)
    with pytest.raises(ValueError, match="ind_slab"):
        ChunkedGLSource(str(d / "g.bin"), N, S, binary=True,
                        ind_slab=(4, 3))
    src = ChunkedGLSource(str(d / "g.bin"), N, S, binary=True, probs=True)
    with pytest.raises(TypeError):
        src[::2]
