"""bf16 gl-slab tier: half-byte slab storage for the GL-fused chain
kernels.

Only the gl INPUT is quantised (bf16, ~2^-9 relative); every kernel
upcasts at load and computes f32. Gates are therefore input-noise
envelopes (~1e-3 on freq, ~1e-4 relative on likelihoods), not the f32
tier's 2e-5 kernel-agreement gates. The streaming auto rule must keep
byte-exactness everywhere it is gated: f32 whenever the f32 slabs fully
pin or the cache is off (NGSF_STREAM_CACHE_BYTES=0 stays a pure
memoisation switch)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from ngsf_hmm.models import hmm_pallas as hp
from ngsf_hmm.models.em import EMOptions, em_iteration, init_state
from ngsf_hmm.models.streaming import StreamingEM


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(91)
    S, N = 2000, 40
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
    dist = np.abs(rng.random(S)) * 0.05
    return (jnp.asarray(gl, jnp.float32),
            jnp.asarray(dist, jnp.float32))


def _preps(gl, dist):
    p32 = hp.prepare_gl_inputs(jnp.exp(gl), dist)
    p16 = hp.prepare_gl_inputs(jnp.exp(gl), dist, gl_dtype=jnp.bfloat16)
    return p32, p16


def test_bf16_slabs_halve_bytes_and_posteriors_close(data):
    gl, dist = data
    N = gl.shape[1]
    p32, p16 = _preps(gl, dist)
    assert p16["g0"].dtype == jnp.bfloat16
    assert p16["g0"].size == p32["g0"].size
    F = jnp.linspace(0.1, 0.6, N, dtype=jnp.float32)
    a = jnp.linspace(0.02, 0.2, N, dtype=jnp.float32)
    outs = []
    for prep in (p32, p16):
        fc = hp.freq_compact(jnp.full(gl.shape[:1], 0.2, jnp.float32), prep)
        outs.append(hp.posteriors_fused(F, a, prep, fc))
    (pA, lfA, lbA), (pB, lfB, lbB) = outs
    # near-uncertain sites amplify the 2^-9 input quantisation through
    # the chain: the TAIL reaches a few e-2 on ~0.5% of cells while the
    # bulk stays ~1e-3 -- gate both
    d = np.abs(np.asarray(pB) - np.asarray(pA))
    assert d.max() < 8e-2
    assert np.percentile(d, 99) < 3e-2
    assert np.median(d) < 5e-3
    np.testing.assert_allclose(np.asarray(lfB), np.asarray(lfA), rtol=5e-4)
    np.testing.assert_allclose(np.asarray(lbB), np.asarray(lbA), rtol=5e-4)


def test_em_iteration_gl_bf16_trajectory_close(data):
    gl, dist = data
    S, N = gl.shape[0], gl.shape[1]
    st0 = init_state(
        gl, jnp.full((S,), 0.2, jnp.float32),
        jnp.linspace(0.1, 0.6, N, dtype=jnp.float32),
        jnp.linspace(0.02, 0.2, N, dtype=jnp.float32),
    )
    finals = []
    for bf16 in (False, True):
        st = st0
        slabs = opt = None
        for _ in range(3):
            st, _, slabs, opt = em_iteration(
                gl, dist, st, numerics="pallas", gl_bf16=bf16,
                prep_slabs=slabs, return_prep=True,
                opt_memory=opt, return_opt=True,
            )
        finals.append(st)
    f32_st, b16_st = finals
    np.testing.assert_allclose(np.asarray(b16_st.freq),
                               np.asarray(f32_st.freq), atol=3e-3)
    # likelihoods agree to input-noise level (per-ind ll ~ -1e3)
    np.testing.assert_allclose(np.asarray(b16_st.ind_lkl),
                               np.asarray(f32_st.ind_lkl), rtol=5e-4)
    # threaded slabs keep their dtype across iterations
    assert finals[1].freq.dtype == jnp.float32


def _plan(gl, dist, cache_bytes, slab_bf16="auto", numerics="pallas"):
    old = os.environ.get("NGSF_STREAM_CACHE_BYTES")
    if cache_bytes is None:
        os.environ.pop("NGSF_STREAM_CACHE_BYTES", None)
    else:
        os.environ["NGSF_STREAM_CACHE_BYTES"] = cache_bytes
    try:
        se = StreamingEM(np.asarray(gl, np.float64), np.asarray(dist),
                         chunk_sites=512, slab_bf16=slab_bf16)
        se._config_kernel(EMOptions(numerics=numerics))
        return se
    finally:
        if old is None:
            os.environ.pop("NGSF_STREAM_CACHE_BYTES", None)
        else:
            os.environ["NGSF_STREAM_CACHE_BYTES"] = old


def test_streaming_auto_bf16_rule(data):
    """auto engages bf16 exactly on a PARTIAL f32 pin; forced values
    win; cache-off and full-pin runs stay f32."""
    gl, dist = data
    probe = _plan(gl, dist, str(1 << 30))
    e_b, _ = probe._slab_bytes()  # f32 per-chunk slab bytes (full pin)
    assert probe._slab_dt == jnp.float32 and probe._pin_k == probe.C

    se = _plan(gl, dist, str(int(e_b * 1.5)))  # fits 1 of 4 chunks @f32
    assert se._slab_dt == jnp.bfloat16
    assert se._pin_k == 3  # bf16 halves e_b -> the budget pins 2x + d
    se = _plan(gl, dist, "0")  # cache disabled: memoisation-only switch
    assert se._slab_dt == jnp.float32 and not se._cache_e
    se = _plan(gl, dist, str(int(e_b * 1.5)), slab_bf16=False)
    assert se._slab_dt == jnp.float32 and se._pin_k == 1
    se = _plan(gl, dist, str(1 << 30), slab_bf16=True)
    assert se._slab_dt == jnp.bfloat16 and se._pin_k == se.C
    # blocked tier never goes bf16 (the e-slabs are not gl slabs)
    se = _plan(gl, dist, str(int(e_b * 1.5)), numerics="linear")
    assert se._slab_dt == jnp.float32


def test_streaming_bf16_trajectory_close(data):
    """Forced-bf16 fused stream vs the f32 fused stream: input-noise
    level agreement on freq and likelihoods."""
    gl, dist = data
    gl = np.asarray(gl, np.float64)[:700]
    dist = np.asarray(dist, np.float64)[:700]
    S, N = gl.shape[0], gl.shape[1]
    freq0 = np.full(S, 0.2)
    F0 = np.linspace(0.1, 0.6, N)
    a0 = np.linspace(0.02, 0.2, N)
    base = dict(numerics="pallas", min_iters=2, max_iters=3,
                min_epsilon=1e-4)
    outs = []
    for bf16 in (False, True):
        se = StreamingEM(gl, dist, chunk_sites=256, slab_bf16=bf16)
        outs.append(se.run(freq0, F0, a0, EMOptions(**base)))
        assert se._slab_dt == (jnp.bfloat16 if bf16 else jnp.float32)
    (f32_f, f32_F, _, f32_ll, it32), (b_f, b_F, _, b_ll, it16) = outs
    assert it32 == it16
    np.testing.assert_allclose(b_f, f32_f, atol=8e-3)
    # per-ind lls: the bf16 arm's optimizer endpoints legitimately
    # wander ~1e-3 relative under the input quantisation (line-search
    # accept/reject flips near thresholds), so the cross-dtype gate is
    # an input-noise envelope, not a kernel-agreement bound
    np.testing.assert_allclose(b_ll, f32_ll, rtol=3e-3)
    # F endpoints: weakly-identified individuals (F near a bound after
    # only 3 EM iterations) can land visibly apart under input noise --
    # gate the bulk tightly and cap the tail
    dF = np.abs(b_F - f32_F)
    assert np.percentile(dF, 90) < 3e-2
    assert dF.max() < 0.15
