"""GL-fused chain kernels (Pallas, Triton route) vs the f64 sequential
oracle kernels.

The kernels (models/hmm_pallas.py) stream genotype-likelihood slabs plus
per-site freq/dist compacts and compute emissions IN-KERNEL (reference
math shared/HMM.cpp:144-154 + gen_func.cpp:938-957). They run in the
Pallas interpreter on the CPU -- the same kernel code the GPU compiles
through Triton, whose lowering is checked here too; f32 tolerances as
in the blocked-linear tests. Checks at real widths on the card live in
chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oracle
from ngsf_hmm.models.hmm import (
    forward_loglik,
    loglik_value_and_grad,
    posteriors,
)
from ngsf_hmm.models import hmm_pallas as hp

RNG = np.random.default_rng(37)


def _case(S, N, br=0):
    gl, freq, dist, F, alpha, e = oracle.random_case(
        RNG, S=S, N=N, chrom_break_every=br
    )
    gl_lin = jnp.exp(jnp.asarray(np.transpose(gl, (1, 0, 2))))  # [S, N, 3]
    return (gl_lin, jnp.asarray(freq), jnp.asarray(dist), jnp.asarray(F),
            jnp.asarray(alpha), jnp.asarray(e))


def _prep(gl_lin, freq, dist, bs=None, nb_p=None):
    prep2 = hp.prepare_gl_inputs(gl_lin, dist, bs=bs, nb_p=nb_p)
    fc = hp.freq_compact(freq, prep2)
    return prep2, fc


@pytest.mark.parametrize("S,N,br", [
    (61, 4, 17), (128, 8, 0), (333, 5, 101), (40, 3, 0), (130, 11, 0),
])
def test_fused_loglik_matches(S, N, br):
    gl_lin, freq, dist, F, alpha, e = _case(S, N, br)
    prep2, fc = _prep(gl_lin, freq, dist)
    ll_p = hp.forward_loglik_fused(F[None], alpha[None], prep2, fc)[0]
    ll_s = forward_loglik(F, alpha, e, dist)
    np.testing.assert_allclose(np.asarray(ll_p), np.asarray(ll_s), rtol=2e-6)


def test_fused_loglik_explicit_geometry():
    """Non-default bs/nb_p (multi-row blocks, partial lane groups)."""
    gl_lin, freq, dist, F, alpha, e = _case(517, 9, 100)
    prep2, fc = _prep(gl_lin, freq, dist, bs=3, nb_p=256)
    ll_p = hp.forward_loglik_fused(F[None], alpha[None], prep2, fc)[0]
    ll_s = forward_loglik(F, alpha, e, dist)
    np.testing.assert_allclose(np.asarray(ll_p), np.asarray(ll_s), rtol=2e-6)


def test_fused_loglik_candidate_batch():
    gl_lin, freq, dist, F, alpha, e = _case(77, 4, 13)
    prep2, fc = _prep(gl_lin, freq, dist)
    Fs = jnp.stack([F, F * 0.7, jnp.clip(F * 1.2, 0, 0.99)])
    As = jnp.stack([alpha, alpha * 2.0, alpha * 0.5])
    ll_b = hp.forward_loglik_fused(Fs, As, prep2, fc)
    for k in range(3):
        ll_s = forward_loglik(Fs[k].astype(jnp.float64),
                              As[k].astype(jnp.float64), e, dist)
        np.testing.assert_allclose(np.asarray(ll_b[k]), np.asarray(ll_s),
                                   rtol=2e-6)


@pytest.mark.parametrize("S,N,br", [(61, 4, 17), (200, 6, 47)])
def test_fused_value_and_grad_matches(S, N, br):
    gl_lin, freq, dist, F, alpha, e = _case(S, N, br)
    prep2, fc = _prep(gl_lin, freq, dist)
    L_p, gF_p, ga_p = hp.loglik_value_and_grad_fused(F, alpha, prep2, fc)
    L_s, gF_s, ga_s = loglik_value_and_grad(F, alpha, e, dist)
    np.testing.assert_allclose(np.asarray(L_p), np.asarray(L_s), rtol=2e-6)
    np.testing.assert_allclose(np.asarray(gF_p), np.asarray(gF_s), rtol=2e-3)
    np.testing.assert_allclose(np.asarray(ga_p), np.asarray(ga_s), rtol=2e-3)


@pytest.mark.parametrize("S,N,br", [(61, 4, 17), (150, 5, 0)])
def test_fused_posteriors_match(S, N, br):
    gl_lin, freq, dist, F, alpha, e = _case(S, N, br)
    prep2, fc = _prep(gl_lin, freq, dist)
    p_p, llf_p, llb_p = hp.posteriors_fused(F, alpha, prep2, fc)
    p_s, llf_s, llb_s = posteriors(e, dist, F, alpha)
    np.testing.assert_allclose(np.asarray(p_p), np.asarray(p_s), atol=2e-5)
    np.testing.assert_allclose(np.asarray(llf_p), np.asarray(llf_s),
                               rtol=2e-6)
    np.testing.assert_allclose(np.asarray(llb_p), np.asarray(llb_s),
                               rtol=2e-6)


def test_fused_posteriors_with_carries():
    """Boundary carries split the chain exactly like v1 (the streaming
    engine's chunk algebra)."""
    gl_lin, freq, dist, F, alpha, e = _case(120, 3, 0)
    cut = 64
    p_s, _, _ = posteriors(e, dist, F, alpha)
    # whole-chain transfer products of each half via the fused kernel
    prepA, fcA = _prep(gl_lin[:cut], freq[:cut], dist[:cut])
    prepB, fcB = _prep(gl_lin[cut:], freq[cut:], dist[cut:])
    A_rA, _ = hp.block_transfers_fused(F[None], alpha[None], prepA, fcA)
    A_rB, _ = hp.block_transfers_fused(F[None], alpha[None], prepB, fcB)
    TA, _ = hp.fold_transfers_pallas(A_rA)
    TB, _ = hp.fold_transfers_pallas(A_rB)
    TA, TB = np.asarray(TA[0], np.float64), np.asarray(TB[0], np.float64)
    q = np.stack([1.0 - np.asarray(F), np.asarray(F)], -1)
    v0B = np.einsum("nk,nkl->nl", q, TA)
    v0B /= v0B.max(-1, keepdims=True)
    wTA = np.einsum("nkl,nl->nk", TB, np.ones((3, 2)))
    wTA /= wTA.max(-1, keepdims=True)
    pA, _, _ = hp.posteriors_fused(
        F, alpha, prepA, fcA, wT=jnp.asarray(wTA, jnp.float32)
    )
    pB, _, _ = hp.posteriors_fused(
        F, alpha, prepB, fcB, v0=jnp.asarray(v0B, jnp.float32)
    )
    p_f = np.concatenate([np.asarray(pA), np.asarray(pB)])
    np.testing.assert_allclose(p_f, np.asarray(p_s), atol=3e-5)


def test_pad_individuals_are_inert():
    """Odd N (9 individuals): every individual's lanes are its own; no
    neighbour leaks into real outputs."""
    gl_lin, freq, dist, F, alpha, e = _case(50, 9, 0)
    prep2, fc = _prep(gl_lin, freq, dist)
    ll = hp.forward_loglik_fused(F[None], alpha[None], prep2, fc)[0]
    ll_s = forward_loglik(F, alpha, e, dist)
    assert ll.shape == (9,)
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_s), rtol=2e-6)


def test_freq_compact_valid_mask():
    """site_compact's valid mask turns tail sites into exact no-ops
    (the streaming last-chunk padding path)."""
    gl_lin, freq, dist, F, alpha, e = _case(80, 4, 0)
    # chain over the first 60 sites only
    prep2 = hp.prepare_gl_inputs(gl_lin, dist)
    fc = hp.freq_compact(freq, prep2, valid=60)
    # pad rows must also kill the transition: d beyond valid -> 0
    dc = hp.site_compact(jnp.where(jnp.arange(80) >= 60, 0.0, dist),
                         prep2["bs"], prep2["nb_p"], 0.0)
    prep2 = dict(prep2, dc=dc)
    ll = hp.forward_loglik_fused(F[None], alpha[None], prep2, fc)[0]
    ll_s = forward_loglik(F, alpha, e[:60], dist[:60])
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_s), rtol=2e-6)


def test_pick_geom2():
    bs, nb_p = hp.pick_geom2(1_000_000, 100)
    assert nb_p % hp.LANE_TILE == 0
    assert -(-1_000_000 // bs) <= nb_p
    nb, L, tile = hp._geom2(1_000_000, 100, bs, nb_p)
    assert L == 100 * nb_p and tile == hp.LANE_TILE
    # enough chains in flight to fill the card's 132 SMs many times over
    assert L // tile >= 8 * 132


@pytest.mark.parametrize("S,N", [
    (1_000_000, 100), (10_000, 10), (250_000, 1000), (100, 3),
])
def test_pick_geom2_gpu_rules(S, N):
    """Power-of-two lane tiles that never straddle individuals, blocks
    of >= MIN_BLOCK sites (or the whole input when it is short), and no
    more chains than the card holds in flight."""
    bs, nb_p = hp.pick_geom2(S, N)
    nb, L, tile = hp._geom2(S, N, bs, nb_p)
    assert tile & (tile - 1) == 0 and hp.MIN_TILE <= tile <= hp.LANE_TILE
    assert nb_p % tile == 0 and nb <= nb_p
    assert nb * bs >= S
    assert bs >= min(hp.MIN_BLOCK, -(-S // nb_p))
    # at most one lane tile of padding per individual above the target
    assert L <= max(hp.LANES_TARGET, N) + N * tile
    if S >= hp.MIN_BLOCK * hp.LANE_TILE:
        assert tile == hp.LANE_TILE


@pytest.mark.parametrize("nb_p", [12, 200])
def test_geom2_rejects_bad_block_padding(nb_p):
    with pytest.raises(ValueError, match="nb_p"):
        hp._geom2(100, 3, 10, nb_p)


@pytest.mark.parametrize("S,N,bs,nb_p", [(100, 3, 10, 16), (100, 3, 10, 256)])
def test_lane_tile_padding_is_inert(S, N, bs, nb_p):
    """Pad blocks (nb < nb_p, up to whole pad tiles) carry the freq
    sentinel and d = 0: exact no-ops for the loglik and the posterior."""
    gl_lin, freq, dist, F, alpha, e = _case(S, N, 0)
    prep2, fc = _prep(gl_lin, freq, dist, bs=bs, nb_p=nb_p)
    assert prep2["nb"] == 10 and prep2["L"] == N * nb_p
    ll = hp.forward_loglik_fused(F[None], alpha[None], prep2, fc)[0]
    ll_s = forward_loglik(F, alpha, e, dist)
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_s), rtol=2e-6)
    p_p, _, _ = hp.posteriors_fused(F, alpha, prep2, fc)
    p_s, _, _ = posteriors(e, dist, F, alpha)
    np.testing.assert_allclose(np.asarray(p_p), np.asarray(p_s), atol=2e-5)


_V1_SHAPES = [(61, 4, 8, 17), (128, 8, 16, 0), (333, 5, 64, 101),
              (40, 3, 40, 0)]


@pytest.mark.parametrize("S,N,bs,br", _V1_SHAPES)
def test_fused_loglik_explicit_block_size(S, N, bs, br):
    """Caller-chosen block sizes, chromosome breaks included."""
    gl_lin, freq, dist, F, alpha, e = _case(S, N, br)
    prep2, fc = _prep(gl_lin, freq, dist, bs=bs)
    ll_p = hp.forward_loglik_fused(F[None], alpha[None], prep2, fc)[0]
    ll_s = forward_loglik(F, alpha, e, dist)
    np.testing.assert_allclose(np.asarray(ll_p), np.asarray(ll_s), rtol=2e-6)


@pytest.mark.parametrize("S,N,bs,br", [(61, 4, 8, 17), (200, 6, 32, 47)])
def test_fused_value_and_grad_explicit_block_size(S, N, bs, br):
    gl_lin, freq, dist, F, alpha, e = _case(S, N, br)
    prep2, fc = _prep(gl_lin, freq, dist, bs=bs)
    L_p, gF_p, ga_p = hp.loglik_value_and_grad_fused(F, alpha, prep2, fc)
    L_s, gF_s, ga_s = loglik_value_and_grad(F, alpha, e, dist)
    np.testing.assert_allclose(np.asarray(L_p), np.asarray(L_s), rtol=2e-6)
    np.testing.assert_allclose(np.asarray(gF_p), np.asarray(gF_s), rtol=2e-3)
    np.testing.assert_allclose(np.asarray(ga_p), np.asarray(ga_s), rtol=2e-3)


@pytest.mark.parametrize("S,N,bs,br", [(61, 4, 8, 17), (150, 5, 50, 0)])
def test_fused_posteriors_explicit_block_size(S, N, bs, br):
    gl_lin, freq, dist, F, alpha, e = _case(S, N, br)
    prep2, fc = _prep(gl_lin, freq, dist, bs=bs)
    p_p, llf_p, llb_p = hp.posteriors_fused(F, alpha, prep2, fc)
    p_s, llf_s, llb_s = posteriors(e, dist, F, alpha)
    np.testing.assert_allclose(np.asarray(p_p), np.asarray(p_s), atol=2e-5)
    np.testing.assert_allclose(np.asarray(llf_p), np.asarray(llf_s),
                               rtol=2e-6)
    np.testing.assert_allclose(np.asarray(llb_p), np.asarray(llb_s),
                               rtol=2e-6)


def _bf16_case(S, N, br):
    """A case whose oracle sees exactly the GLs bf16 slabs hold: gl0 and
    gl2 rounded to bf16, gl1 = 1 - gl0 - gl2 as the kernels rebuild it."""
    gl_lin, freq, dist, F, alpha, _ = _case(S, N, br)
    g = np.asarray(gl_lin)
    g0 = np.asarray(jnp.asarray(g[..., 0], jnp.bfloat16), np.float64)
    g2 = np.asarray(jnp.asarray(g[..., 2], jnp.bfloat16), np.float64)
    gq = np.stack([g0, 1.0 - g0 - g2, g2], -1)
    f = np.asarray(freq)[:, None]
    e0 = gq[..., 0] * (1 - f) ** 2 + gq[..., 1] * 2 * f * (1 - f) \
        + gq[..., 2] * f ** 2
    e1 = gq[..., 0] * ((1 - f) ** 2 + f * (1 - f)) + gq[..., 1] * 1e-15 \
        + gq[..., 2] * (f ** 2 + f * (1 - f))
    e = jnp.asarray(np.log(np.stack([e0, e1], -1)))
    prep2 = hp.prepare_gl_inputs(gl_lin, dist, gl_dtype=jnp.bfloat16)
    assert prep2["g0"].dtype == jnp.bfloat16
    return prep2, hp.freq_compact(freq, prep2), dist, F, alpha, e


@pytest.mark.parametrize("what", ["loglik", "grad", "posteriors"])
def test_fused_bf16_slabs_match_quantised_oracle(what):
    """bf16 slabs only quantise the gl INPUT: the kernels upcast at load
    and keep f32 math, so they match the f64 oracle on the quantised
    GLs to f32 tolerance."""
    prep2, fc, dist, F, alpha, e = _bf16_case(97, 5, 31)
    if what == "loglik":
        ll = hp.forward_loglik_fused(F[None], alpha[None], prep2, fc)[0]
        np.testing.assert_allclose(
            np.asarray(ll), np.asarray(forward_loglik(F, alpha, e, dist)),
            rtol=2e-6)
    elif what == "grad":
        got = hp.loglik_value_and_grad_fused(F, alpha, prep2, fc)
        want = loglik_value_and_grad(F, alpha, e, dist)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                                   rtol=2e-6)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=2e-3)
    else:
        p_p, _, _ = hp.posteriors_fused(F, alpha, prep2, fc)
        p_s, _, _ = posteriors(e, dist, F, alpha)
        np.testing.assert_allclose(np.asarray(p_p), np.asarray(p_s),
                                   atol=2e-5)


@pytest.mark.parametrize("platform,interp", [
    ("cpu", True), ("gpu", False), ("neuron", None),
])
def test_interpret_mode_predicate(platform, interp):
    """Interpreter on the CPU, Triton on the GPU, an error anywhere
    else -- never inferred from 'not some other platform'."""
    if interp is None:
        with pytest.raises(RuntimeError, match="no route"):
            hp.interpret_mode(platform)
    else:
        assert hp.interpret_mode(platform) is interp


@pytest.mark.parametrize("gl_dtype", [jnp.float32, jnp.bfloat16])
def test_kernels_lower_to_triton(monkeypatch, gl_dtype):
    """Every kernel lowers through Pallas' Triton route to XLA's Triton
    custom call. Cross-platform lowering needs no GPU: this catches a
    primitive the route cannot lower, or a non-power-of-two load, here
    instead of on the card."""
    monkeypatch.setattr(hp, "interpret_mode", lambda platform=None: False)
    S, N = 3000, 6
    f32 = jnp.float32

    def run(gl, dist, freq, F, a):
        prep2 = hp.prepare_gl_inputs(gl, dist, gl_dtype=gl_dtype)
        fc = hp.freq_compact(freq, prep2)
        return (hp.forward_loglik_fused(F[None], a[None], prep2, fc),
                hp.loglik_value_and_grad_fused(F, a, prep2, fc),
                hp.posteriors_fused(F, a, prep2, fc))

    args = (jnp.full((S, N, 3), 1 / 3, f32), jnp.full((S,), 0.1, f32),
            jnp.full((S,), 0.2, f32), jnp.full((N,), 0.2, f32),
            jnp.full((N,), 0.05, f32))
    text = jax.jit(run).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    for name in ("ngsf_chain_transfer", "ngsf_chain_transfer_grad",
                 "ngsf_chain_bw", "ngsf_chain_fw_post"):
        assert name in text
    # loglik: transfer; grad: transfer_grad; posteriors: transfer, bw,
    # fw_post -- no kernel falls back to the interpreter
    assert text.count("__gpu$xla.gpu.triton") == 5
