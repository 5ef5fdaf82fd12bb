"""GL-fused chain kernels for the f32 speed tier (Pallas, Triton route).

Every pass of the blocked linear-space HMM (hmm_blocked.py) is a
sequential recursion over the sites of a block, one independent chain
per (block, individual) pair. The XLA form runs that recursion as
depth-bs ``lax.scan`` loops, one device loop step (at least one kernel
launch on a GPU) per site. These kernels instead run the whole
recursion inside one program per tile of chains: a ``fori_loop`` over
the block's sites with the 2x2 carries in registers, reading one site's
row of genotype likelihoods per step.

Layout ("lanes"). Sites are split into nb blocks of bs; the chain of
block j for individual n lives on lane l = n * nb_p + j, where nb_p >=
nb pads the block count to a multiple of the lane tile. Streams:

  gl0, gl2 slabs   [bs, N * nb_p]  linear GLs, cell (r, l) = site j*bs + r
                   (gl1 = 1 - gl0 - gl2: readers normalise linear GLs)
  freq/dist        [bs, nb_p]      per-SITE compacts, shared by every
                   individual's lanes (N x fewer bytes than a per-cell
                   slab)

Emissions are computed in-kernel from (gl, freq) (reference math:
shared/HMM.cpp:144-154 with the HWE priors of gen_func.cpp:938-957).
Pad sites and pad blocks carry freq = 2.0 (a sentinel that forces the
emissions to exactly 1) and d = 0 (identity transitions), so pads are
exact no-ops whatever the gl pad bytes hold.

f32 range: after every site the carries are rescaled by an exact power
of two taken from the exponent field of their max (bitcast >> 23) and
the integer exponents are summed; the log offset is exponent_sum * ln2.
Power-of-two scaling is exact in binary floating point.

Each stream's BlockSpec spans all bs sites of one lane tile. On the
Triton route a BlockSpec stages nothing: it fixes the base pointer and
strides of the program's view of the array, and ``ref[r, :]`` inside
the site loop is one contiguous load of the tile's lanes at site r.

Kernels (one program per lane tile, grid = N * nb_p / tile):
  _k_transfer       per-block transfer products + log offsets, for B
                    candidate parameter rows
  _k_transfer_grad  the same product with its (F, alpha) forward-mode
                    tangents (one stream per L-BFGS value-and-grad probe)
  _k_bw             reversed stream emitting the backward ratio
                    bw1 / (bw0 + bw1) per site
  _k_fw_post        forward stream emitting the IBD posterior per site

The cross-block combine is a plain XLA associative scan (_combine_blocks).
On the CPU the kernels run in the Pallas interpreter (the tests); on the
GPU they are compiled through Triton.
"""

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

_TINY = 1e-30
_LN2 = 0.6931471805599453
_HET_FLOOR = 1e-15  # linear het floor, calc_HWE F==1 (gen_func.cpp:946-956)

LANE_TILE = 128  # lanes (chains) per program: one per thread at 4 warps
MIN_TILE = 16  # smallest lane tile (short inputs)
LANES_TARGET = 1 << 18  # chains in flight: ~132 SMs x 2048 threads
MIN_BLOCK = 64  # fewest sites per block the picker chooses


def interpret_mode(platform=None):
    """Whether the kernels run in the Pallas interpreter: on the CPU
    yes (tests), on the GPU no (compiled through Triton). Any other
    platform has no route and is an error."""
    platform = jax.default_backend() if platform is None else platform
    if platform == "cpu":
        return True
    if platform in ("gpu", "cuda"):
        return False
    raise RuntimeError(
        f"the chain kernels have no route for platform {platform!r} "
        "(cpu: Pallas interpreter, gpu: Triton)"
    )


def _t_elems(F, a, d):
    x = jnp.exp(-a * d)
    onem = 1.0 - x
    t00 = onem * (1.0 - F) + x
    t01 = onem * F
    t10 = onem * (1.0 - F)
    t11 = onem * F + x
    return t00, t01, t10, t11


def _pow2_rescale(mx):
    """(scale, exponent): scale = 2^-e with e = floor(log2(mx)), both
    derived from mx's f32 exponent field. Multiplying the carries by
    `scale` is EXACT; summing `exponent` (as f32 counts, integers up to
    ~2^24 are exact) replaces the per-site log accumulation."""
    i32 = jnp.int32
    bits = jax.lax.bitcast_convert_type(mx, i32)
    full = jnp.full(mx.shape, i32(23), i32)
    exb = jax.lax.shift_right_logical(bits, full)  # biased exponent, 0..254
    scale = jax.lax.bitcast_convert_type(
        jax.lax.shift_left(i32(254) - exb, full), jnp.float32
    )
    return scale, (exb - i32(127)).astype(jnp.float32)


def _mat_mul4(a, b):
    """2x2 row-major products, elementwise over any leading dims."""
    a00, a01, a10, a11 = a
    b00, b01, b10, b11 = b
    return (
        a00 * b00 + a01 * b10,
        a00 * b01 + a01 * b11,
        a10 * b00 + a11 * b10,
        a10 * b01 + a11 * b11,
    )


def _add4(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _max4(m):
    return jnp.maximum(jnp.maximum(m[0], m[1]), jnp.maximum(m[2], m[3]))


# ---------------------------------------------------------------------------
# geometry and layout
# ---------------------------------------------------------------------------


def lane_tile(nb_p):
    """Lanes per program for a padded block count."""
    return min(LANE_TILE, nb_p)


def _pad_blocks(nb):
    """Smallest valid nb_p >= nb: a power of two up to LANE_TILE, a
    multiple of LANE_TILE above it (so lane tiles never straddle two
    individuals)."""
    if nb <= LANE_TILE:
        return max(MIN_TILE, 1 << (max(nb, 1) - 1).bit_length())
    return -(-nb // LANE_TILE) * LANE_TILE


def pick_geom2(S, N):
    """(bs, nb_p) for S sites x N individuals: enough blocks that the
    N * nb_p chains fill the card (LANES_TARGET), but never fewer than
    MIN_BLOCK sites per block. The cross-block combine is a log-depth
    scan, so more blocks cost little."""
    S, N = max(S, 1), max(N, 1)
    nb = max(1, min(LANES_TARGET // N, -(-S // MIN_BLOCK)))
    nb_p = _pad_blocks(nb)
    bs = -(-S // nb_p)
    return bs, nb_p


def _geom2(S, N, bs, nb_p):
    """(nb, L, tile) for a layout; validates nb_p."""
    nb = -(-S // bs)
    if nb > nb_p:
        raise ValueError(f"nb {nb} exceeds nb_p {nb_p}")
    if _pad_blocks(nb_p) != nb_p:
        raise ValueError(
            f"nb_p {nb_p} must be a power of two >= {MIN_TILE} up to "
            f"{LANE_TILE}, or a multiple of {LANE_TILE}"
        )
    return nb, N * nb_p, lane_tile(nb_p)


def gl_slabs(gl_lin, bs, nb_p, dtype=jnp.float32):
    """[S, N, 3] LINEAR gls -> (gl0, gl2) [bs, N * nb_p] slabs.

    Built once per run (gl is constant across EM iterations). Pad cells
    get 1/3 (any finite value works: the freq-compact sentinel forces
    pad emissions to 1).

    dtype: slab storage dtype. jnp.bfloat16 halves the slabs' device
    footprint and every pass's stream bytes; the kernels upcast at load,
    so only the gl INPUT is quantised (~2^-9 relative) and the chain
    math stays f32."""
    S, N = gl_lin.shape[0], gl_lin.shape[1]
    nb, L, _ = _geom2(S, N, bs, nb_p)

    def one(ch):
        x = gl_lin[..., ch].astype(jnp.float32)  # [S, N]
        x = jnp.pad(x, ((0, nb * bs - S), (0, 0)), constant_values=1.0 / 3.0)
        x = jnp.transpose(x.reshape(nb, bs, N), (1, 2, 0))  # [bs, N, nb]
        x = jnp.pad(x, ((0, 0), (0, 0), (0, nb_p - nb)),
                    constant_values=1.0 / 3.0)
        return x.reshape(bs, L).astype(dtype)

    return one(0), one(2)


def site_compact(vec, bs, nb_p, pad_value, valid=None):
    """[S] per-site vector -> [bs, nb_p] compact slab.

    valid: sites >= valid (before padding) also get pad_value -- the
    streaming engine's last-chunk masking."""
    S = vec.shape[0]
    f32 = jnp.float32
    nb = -(-S // bs)
    x = vec.astype(f32)
    if valid is not None:
        x = jnp.where(jnp.arange(S) >= valid, f32(pad_value), x)
    x = jnp.pad(x, (0, nb * bs - S), constant_values=pad_value)
    x = jnp.swapaxes(x.reshape(nb, bs), 0, 1)  # [bs, nb]
    return jnp.pad(x, ((0, 0), (0, nb_p - nb)), constant_values=pad_value)


def make_prep2(g0, g2, dc, S, N, bs, nb_p):
    """prep2 dict from laid-out slabs + static geometry (thread slabs
    through jit boundaries without retracing on the int fields)."""
    nb, L, tile = _geom2(S, N, bs, nb_p)
    return dict(g0=g0, g2=g2, dc=dc, S=S, N=N, bs=bs, nb=nb, nb_p=nb_p,
                L=L, tile=tile)


def prepare_gl_inputs(gl_lin, dist, bs=None, nb_p=None,
                      gl_dtype=jnp.float32):
    """(gl_lin [S, N, 3] LINEAR, dist [S]) -> prep2 dict. Run-constant:
    build once, thread everywhere. freq enters separately per iteration
    via freq_compact. bs alone picks the smallest valid nb_p for it."""
    S, N = gl_lin.shape[0], gl_lin.shape[1]
    if bs is None:
        bs, nb_p = pick_geom2(S, N)
    elif nb_p is None:
        nb_p = _pad_blocks(-(-S // bs))
    g0, g2 = gl_slabs(gl_lin, bs, nb_p, dtype=gl_dtype)
    dc = site_compact(jnp.asarray(dist), bs, nb_p, 0.0)
    return make_prep2(g0, g2, dc, S, N, bs, nb_p)


def freq_compact(freq, prep2, valid=None):
    """Per-iteration freq -> compact slab; pad sentinel 2.0 forces pad
    emissions to exactly 1 (identity together with d = 0)."""
    return site_compact(jnp.asarray(freq), prep2["bs"], prep2["nb_p"],
                        2.0, valid=valid)


def _rep_params2(F, alpha, prep2):
    """[B, N] -> [B, L] lane-repeated parameter arrays (f32)."""
    nb_p = prep2["nb_p"]
    f32 = jnp.float32
    return (jnp.repeat(F.astype(f32), nb_p, axis=-1),
            jnp.repeat(alpha.astype(f32), nb_p, axis=-1))


def _unpack_A2(A, prep2):
    """[K, B, L] kernel output -> [nb, K, B, N] per-block view."""
    K, B = A.shape[0], A.shape[1]
    nb, N, nb_p = prep2["nb"], prep2["N"], prep2["nb_p"]
    x = A.reshape(K, B, N, nb_p)[..., :nb]
    return jnp.transpose(x, (3, 0, 1, 2))


def _ends_fold2(vecs, prep2):
    """[nb, 2, 1, N] block vectors -> two [L] lane arrays."""
    nb, nb_p = prep2["nb"], prep2["nb_p"]

    def fold(v):  # [nb, N]
        v = jnp.pad(v.astype(jnp.float32), ((0, nb_p - nb), (0, 0)),
                    constant_values=0.5)
        return v.T.reshape(-1)

    return fold(vecs[:, 0, 0]), fold(vecs[:, 1, 0])


def _unpack_sites2(p, prep2):
    """[bs, L] per-site kernel output -> [S, N]."""
    S, N, bs = prep2["S"], prep2["N"], prep2["bs"]
    nb, nb_p = prep2["nb"], prep2["nb_p"]
    x = p.reshape(bs, N, nb_p)[..., :nb]
    return jnp.transpose(x, (2, 0, 1)).reshape(nb * bs, N)[:S]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _emit(g0, g2, f, d):
    """One site's emissions (e0, e1) for a lane tile: e_k = sum_g gl_g *
    P(g | f, F=k), state 0 HWE and state 1 full IBD. The sentinel f > 1
    marks pad cells: e = 1 exactly."""
    g0 = g0.astype(jnp.float32)
    g2 = g2.astype(jnp.float32)
    g1 = 1.0 - g0 - g2
    one_m = 1.0 - f
    pq = one_m * f
    e0 = g0 * (one_m * one_m) + g1 * (2.0 * pq) + g2 * (f * f)
    e1 = g0 * (one_m * one_m + pq) + g1 * _HET_FLOOR + g2 * (f * f + pq)
    pad = f > 1.0
    return jnp.where(pad, 1.0, e0), jnp.where(pad, 1.0, e1), d


def _site(refs, r):
    """Row r of the (gl0, gl2, freq, dist) streams."""
    g0_ref, g2_ref, fc_ref, dc_ref = refs
    return _emit(g0_ref[r, :], g2_ref[r, :], fc_ref[r, :], dc_ref[r, :])


def _call(kernel, name, out_shape, in_specs, out_specs, geo):
    """pallas_call on the Triton route over one program per lane tile."""
    tile, L = geo["tile"], geo["L"]
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(L // tile,),
        in_specs=in_specs,
        out_specs=out_specs,
        interpret=interpret_mode(),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, min(4, tile // 32)), num_stages=2),
        name=name,
    )


def _stream_specs(geo):
    """Specs of the four site streams: gl slabs per lane tile, compacts
    per block tile (a lane tile never straddles individuals)."""
    bs, tile = geo["bs"], geo["tile"]
    tpi = geo["nb_p"] // tile
    slab = pl.BlockSpec((bs, tile), lambda i: (jnp.int32(0), i))
    comp = pl.BlockSpec((bs, tile), lambda i: (jnp.int32(0), i % tpi))
    return [slab, slab, comp, comp]


def _lane_spec(tile):
    return pl.BlockSpec((tile,), lambda i: (i,))


def _rows_spec(rows, tile):
    return pl.BlockSpec((*rows, tile),
                        lambda i: (jnp.int32(0),) * len(rows) + (i,))


def _site_loop(bs, body, init, reverse=False):
    i32 = jnp.int32
    if reverse:
        return jax.lax.fori_loop(
            i32(0), i32(bs), lambda k, c: body(i32(bs - 1) - k, c), init)
    return jax.lax.fori_loop(i32(0), i32(bs), body, init)


def _k_transfer(B, geo):
    """Per-block transfer products of B candidate parameter rows.
    Output [5, B, L]: 4 rescaled product entries + log offset."""
    bs, tile, L = geo["bs"], geo["tile"], geo["L"]

    def kernel(g0_ref, g2_ref, fc_ref, dc_ref, F_ref, a_ref, out_ref):
        refs = (g0_ref, g2_ref, fc_ref, dc_ref)
        Fs = [F_ref[b, :] for b in range(B)]
        As = [a_ref[b, :] for b in range(B)]

        def body(r, carry):
            e0, e1, d = _site(refs, r)
            out = []
            for b in range(B):  # static; candidate chains are independent
                c, ex = carry[b]
                t00, t01, t10, t11 = _t_elems(Fs[b], As[b], d)
                n = _mat_mul4(c, (t00 * e0, t01 * e1, t10 * e0, t11 * e1))
                sc, e = _pow2_rescale(jnp.maximum(_max4(n), _TINY))
                out.append((tuple(x * sc for x in n), ex + e))
            return tuple(out)

        one = jnp.ones((tile,), jnp.float32)
        zero = jnp.zeros((tile,), jnp.float32)
        init = tuple(((one, zero, zero, one), zero) for _ in range(B))
        res = _site_loop(bs, body, init)
        for b in range(B):
            c, ex = res[b]
            for k in range(4):
                out_ref[k, b, :] = c[k]
            out_ref[4, b, :] = ex * _LN2

    return _call(
        kernel, "ngsf_chain_transfer",
        jax.ShapeDtypeStruct((5, B, L), jnp.float32),
        _stream_specs(geo) + [_rows_spec((B,), tile)] * 2,
        _rows_spec((5, B), tile), geo,
    )


def _k_transfer_grad(geo):
    """ONE stream -> per-block transfer products AND their forward-mode
    (F, alpha) tangents, sharing the primal's per-site rescale.

    Maintains c = M_prod/gamma, D_F = dM_prod/dF/gamma, D_a =
    dM_prod/dalpha/gamma with the SAME running scale gamma, so the
    Fisher-identity ratios [v . D . w] / [v . c . w] of
    grad_from_carries_pallas equal the true dll/dtheta block terms with
    every scale cancelling. The primal leaves and rescale are
    _k_transfer's term for term, so the primal rows equal its B=1
    output. Output [13, L]: c(4), D_F(4), D_a(4), log offset."""
    bs, tile, L = geo["bs"], geo["tile"], geo["L"]

    def kernel(g0_ref, g2_ref, fc_ref, dc_ref, F_ref, a_ref, out_ref):
        refs = (g0_ref, g2_ref, fc_ref, dc_ref)
        F, a = F_ref[:], a_ref[:]

        def body(r, carry):
            cA, cF, ca, off = carry
            e0, e1, d = _site(refs, r)
            x = jnp.exp(-a * d)
            onem = 1.0 - x
            # d = inf at chromosome breaks: x = 0 there, d*x must be 0
            dxp = jnp.where(x > 0.0, d * x, 0.0)
            oe0 = onem * e0
            oe1 = onem * e1
            fd = F * dxp
            gd = (1.0 - F) * dxp
            mA = (
                (onem * (1.0 - F) + x) * e0,
                (onem * F) * e1,
                (onem * (1.0 - F)) * e0,
                (onem * F + x) * e1,
            )
            mF = (-oe0, oe1, -oe0, oe1)
            mda = (-fd * e0, fd * e1, gd * e0, -gd * e1)
            nA = _mat_mul4(cA, mA)
            nF = _add4(_mat_mul4(cF, mA), _mat_mul4(cA, mF))
            na = _add4(_mat_mul4(ca, mA), _mat_mul4(cA, mda))
            sc, e = _pow2_rescale(jnp.maximum(_max4(nA), _TINY))
            return (tuple(v * sc for v in nA), tuple(v * sc for v in nF),
                    tuple(v * sc for v in na), off + e)

        one = jnp.ones((tile,), jnp.float32)
        zero = jnp.zeros((tile,), jnp.float32)
        init = ((one, zero, zero, one), (zero,) * 4, (zero,) * 4, zero)
        cA, cF, ca, off = _site_loop(bs, body, init)
        for k, v in enumerate(cA + cF + ca):
            out_ref[k, :] = v
        out_ref[12, :] = off * _LN2

    return _call(
        kernel, "ngsf_chain_transfer_grad",
        jax.ShapeDtypeStruct((13, L), jnp.float32),
        _stream_specs(geo) + [_lane_spec(tile)] * 2,
        _rows_spec((13,), tile), geo,
    )


def _k_bw(geo):
    """Reversed stream emitting the per-site backward RATIO r = bw1 /
    (bw0 + bw1): the posterior is scale-free in bw, so the ratio carries
    everything fw_post needs, p = fw1*r / (fw0*(1-r) + fw1*r)."""
    bs, tile, L = geo["bs"], geo["tile"], geo["L"]

    def kernel(g0_ref, g2_ref, fc_ref, dc_ref, F_ref, a_ref, w0_ref, w1_ref,
               bwr_ref):
        refs = (g0_ref, g2_ref, fc_ref, dc_ref)
        F, a = F_ref[:], a_ref[:]

        def body(r, carry):
            w0, w1 = carry
            # the carry entering a site is bw at that site: emit it
            bwr_ref[r, :] = w1 / jnp.maximum(w0 + w1, _TINY)
            e0, e1, d = _site(refs, r)
            t00, t01, t10, t11 = _t_elems(F, a, d)
            b0 = (t00 * e0) * w0 + (t01 * e1) * w1
            b1 = (t10 * e0) * w0 + (t11 * e1) * w1
            sc, _ = _pow2_rescale(jnp.maximum(jnp.maximum(b0, b1), _TINY))
            return b0 * sc, b1 * sc

        _site_loop(bs, body, (w0_ref[:], w1_ref[:]), reverse=True)

    return _call(
        kernel, "ngsf_chain_bw",
        jax.ShapeDtypeStruct((bs, L), jnp.float32),
        _stream_specs(geo) + [_lane_spec(tile)] * 4,
        _rows_spec((bs,), tile), geo,
    )


def _k_fw_post(geo):
    """Forward stream emitting the per-site IBD posterior from the
    backward ratio slab: p = fw1*r / (fw0*(1-r) + fw1*r)."""
    bs, tile, L = geo["bs"], geo["tile"], geo["L"]

    def kernel(g0_ref, g2_ref, fc_ref, dc_ref, F_ref, a_ref, v0_ref, v1_ref,
               bwr_ref, p_ref):
        refs = (g0_ref, g2_ref, fc_ref, dc_ref)
        F, a = F_ref[:], a_ref[:]

        def body(r, carry):
            v0, v1 = carry
            e0, e1, d = _site(refs, r)
            t00, t01, t10, t11 = _t_elems(F, a, d)
            n0 = v0 * (t00 * e0) + v1 * (t10 * e0)
            n1 = v0 * (t01 * e1) + v1 * (t11 * e1)
            sc, _ = _pow2_rescale(jnp.maximum(jnp.maximum(n0, n1), _TINY))
            v0, v1 = n0 * sc, n1 * sc
            bwr = bwr_ref[r, :]
            x0 = v0 * (1.0 - bwr)
            x1 = v1 * bwr
            p_ref[r, :] = x1 / jnp.maximum(x0 + x1, _TINY)
            return v0, v1

        _site_loop(bs, body, (v0_ref[:], v1_ref[:]))

    slab = _rows_spec((bs,), tile)
    return _call(
        kernel, "ngsf_chain_fw_post",
        jax.ShapeDtypeStruct((bs, L), jnp.float32),
        _stream_specs(geo) + [_lane_spec(tile)] * 4 + [slab],
        slab, geo,
    )


# ---------------------------------------------------------------------------
# cross-block combine (plain XLA)
# ---------------------------------------------------------------------------


def _comb(a, b):
    """Rescaled 2x2 product combine for the cross-block scans."""
    a4, ae = a
    b4, be = b
    c = _mat_mul4(a4, b4)
    mx = jnp.maximum(_max4(c), _TINY)
    sc, ex = _pow2_rescale(mx)
    return (tuple(x * sc for x in c), ae + be + ex * _LN2)


def _comb_rev(a, b):
    # reverse=True folds elements in reversed index order, so the
    # matrix product must be flipped to keep suffixes in FORWARD
    # site order: suf[j] = A_j . A_{j+1} ... A_{nb-1}
    a4, ae = a
    b4, be = b
    c = _mat_mul4(b4, a4)
    mx = jnp.maximum(_max4(c), _TINY)
    sc, ex = _pow2_rescale(mx)
    return (tuple(x * sc for x in c), ae + be + ex * _LN2)


def _combine_blocks(A_r, F, v0=None, wT=None):
    """Cross-block pass as PLAIN XLA associative scans: the per-block
    transfer products compose under the rescaled 2x2 product, so the
    nb-long chain becomes a log2(nb)-depth prefix scan (forward) +
    suffix scan (backward), vectorized over (B, N).

    A_r [nb, 5, B, N] (4 product entries + log-offset); F [B, N].
    v0 / wT [B, N, 2]: boundary carries when these blocks are one
    segment of a longer chain (a streaming chunk) -- the normalised
    forward vector entering block 0 and backward vector at the last
    block's last site. Defaults ((1-F, F), ones) make this the whole
    chain. With carries the returned lls are SEGMENT-LOCAL values
    (normalisation of the carries drops the other segments' scales);
    posterior and gradient ratios cancel every scale.
    Returns (starts [nb, 2, B, N]: fwd vector entering each block,
    ends [nb, 2, B, N]: bwd vector at each block's last site,
    lls [2, B, N] = (ll_f, ll_b)).
    """
    mats = (A_r[:, 0], A_r[:, 1], A_r[:, 2], A_r[:, 3])
    offs = A_r[:, 4]

    pre4, pre_off = jax.lax.associative_scan(_comb, (mats, offs))
    suf4, suf_off = jax.lax.associative_scan(_comb_rev, (mats, offs),
                                             reverse=True)

    if v0 is None:
        q1 = jnp.asarray(F, jnp.float32)
        q0 = 1.0 - q1
    else:
        q0 = jnp.asarray(v0[..., 0], jnp.float32)
        q1 = jnp.asarray(v0[..., 1], jnp.float32)
    if wT is None:
        w0 = w1 = None
    else:
        w0 = jnp.asarray(wT[..., 0], jnp.float32)
        w1 = jnp.asarray(wT[..., 1], jnp.float32)

    # fwd vector entering block j: v0 . (A_0 ... A_{j-1}); block 0 gets v0
    s0 = q0[None] * pre4[0] + q1[None] * pre4[2]  # [nb, B, N] (inclusive)
    s1 = q0[None] * pre4[1] + q1[None] * pre4[3]
    starts0 = jnp.concatenate([q0[None], s0[:-1]])
    starts1 = jnp.concatenate([q1[None], s1[:-1]])

    # bwd vector at block j's END: (A_{j+1} ... A_{nb-1}) . wT
    if w0 is None:
        e0 = suf4[0] + suf4[1]  # [nb, B, N] (inclusive from the right)
        e1 = suf4[2] + suf4[3]
        last0 = jnp.ones_like(e0[:1])
        last1 = jnp.ones_like(e1[:1])
        ll_f = jnp.log(s0[-1] + s1[-1]) + pre_off[-1]
    else:
        e0 = suf4[0] * w0[None] + suf4[1] * w1[None]
        e1 = suf4[2] * w0[None] + suf4[3] * w1[None]
        last0 = w0[None]
        last1 = w1[None]
        ll_f = jnp.log(s0[-1] * w0 + s1[-1] * w1) + pre_off[-1]
    ends0 = jnp.concatenate([e0[1:], last0])
    ends1 = jnp.concatenate([e1[1:], last1])
    ll_b = jnp.log(q0 * e0[0] + q1 * e1[0]) + suf_off[0]

    starts = jnp.stack([starts0, starts1], axis=1)
    ends = jnp.stack([ends0, ends1], axis=1)
    lls = jnp.stack([ll_f, ll_b])
    return starts, ends, lls


def fold_transfers_pallas(A_r):
    """[nb, 5, B, N] block products -> the whole-slab transfer product
    (T [B, N, 2, 2] rescaled row-major, s [B, N] log scale): a streaming
    chunk's effect on the chain (blocked-linear analog:
    hmm_blocked.fold_transfer_lin)."""
    mats = (A_r[:, 0], A_r[:, 1], A_r[:, 2], A_r[:, 3])
    offs = A_r[:, 4]
    pre4, pre_off = jax.lax.associative_scan(_comb, (mats, offs))
    T = jnp.stack([x[-1] for x in pre4], axis=-1)  # [B, N, 4]
    return T.reshape(*T.shape[:-1], 2, 2), pre_off[-1]


def fold_grad_pallas(A_g):
    """transfer_grad_fused output -> the slab transfer product AND its
    (F, alpha) tangents, folded to one matrix each: (T [N, 2, 2],
    s [N], D_F [N, 2, 2], D_a [N, 2, 2]).

    The tangents share T's rescale (product rule at every combine), so
    a consumer's Fisher ratio [v . D . w] / [v . T . w] equals the true
    d log-scale-free term with every normalisation cancelling -- the
    streamed host chain passes these as (dT, ds=0) to its
    _grad_from_transfers assembly."""
    mats = (A_g[:, 0], A_g[:, 1], A_g[:, 2], A_g[:, 3])
    dF = (A_g[:, 4], A_g[:, 5], A_g[:, 6], A_g[:, 7])
    da = (A_g[:, 8], A_g[:, 9], A_g[:, 10], A_g[:, 11])
    offs = A_g[:, 12]

    def comb(a, b):
        a4, aF, aa, ae = a
        b4, bF, ba, be = b
        c = _mat_mul4(a4, b4)
        cF = _add4(_mat_mul4(aF, b4), _mat_mul4(a4, bF))
        ca = _add4(_mat_mul4(aa, b4), _mat_mul4(a4, ba))
        mx = jnp.maximum(_max4(c), _TINY)
        sc, ex = _pow2_rescale(mx)
        return (
            tuple(x * sc for x in c),
            tuple(x * sc for x in cF),
            tuple(x * sc for x in ca),
            ae + be + ex * _LN2,
        )

    pre4, preF, prea, pre_off = jax.lax.associative_scan(
        comb, (mats, dF, da, offs)
    )

    def last22(t4):
        m = jnp.stack([x[-1] for x in t4], axis=-1)  # [B, N, 4]
        return m.reshape(*m.shape[:-1], 2, 2)

    assert pre_off.shape[1] == 1
    return (
        last22(pre4)[0],
        pre_off[-1, 0],
        last22(preF)[0],
        last22(prea)[0],
    )


def grad_from_carries_pallas(A_g, F, v0=None, wT=None, with_init_term=1.0):
    """Fisher-identity (ll_local, dL/dF, dL/dalpha) from the fused
    stream's block tangents, each [N].

    v0/wT [N, 2]: segment boundary carries (None = whole chain, where
    ll_local IS the chain loglik). with_init_term: traced 0/1 weight on
    the initial-distribution dq/dF term -- the whole chain's site 0
    belongs to the first segment only.

      dll/dtheta = sum_j [v_j . dM_j . w_j] / [v_j . M_j . w_j]
    """
    F2 = jnp.asarray(F, jnp.float32)[None, :]
    A_prim = jnp.concatenate([A_g[:, 0:4], A_g[:, 12:13]], axis=1)
    v0b = None if v0 is None else v0[None]
    wTb = None if wT is None else wT[None]
    starts, ends, lls = _combine_blocks(A_prim, F2, v0b, wTb)

    v0_, v1_ = starts[:, 0, 0], starts[:, 1, 0]  # [nb, N] entering block j
    w0_, w1_ = ends[:, 0, 0], ends[:, 1, 0]  # [nb, N] at block j's end
    T = A_g[:, 0:4, 0]  # [nb, 4, N] (c, shared normalisation with D)
    DF = A_g[:, 4:8, 0]
    Da = A_g[:, 8:12, 0]

    def quad(M):
        return v0_ * (M[:, 0] * w0_ + M[:, 1] * w1_) + v1_ * (
            M[:, 2] * w0_ + M[:, 3] * w1_
        )

    inv = 1.0 / jnp.maximum(quad(T), _TINY)
    gF = (quad(DF) * inv).sum(0)
    ga = (quad(Da) * inv).sum(0)

    # Initial-distribution term (block 0): X_k = (T_0 . w_0)_k,
    # d log(q . X)/dF with dq/dF = (-1, +1); scales cancel in the ratio.
    X0 = T[0, 0] * w0_[0] + T[0, 1] * w1_[0]
    X1 = T[0, 2] * w0_[0] + T[0, 3] * w1_[0]
    q1 = F2[0]
    tot = (1.0 - q1) * X0 + q1 * X1
    gF = gF + with_init_term * (X1 - X0) / jnp.maximum(tot, _TINY)
    return lls[0, 0], gF, ga


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _streams(prep2, fc):
    return prep2["g0"], prep2["g2"], fc, prep2["dc"]


def block_transfers_fused(F, alpha, prep2, fc):
    """Per-block transfer products for [B, N] params: one streamed pass
    over the gl slabs with in-kernel emissions. Returns (A_r [nb, 5, B,
    N] (4 rescaled product entries + log-offset row), reps) where reps
    are the lane-repeated params the per-site kernels reuse."""
    F = jnp.asarray(F, jnp.float32)
    alpha = jnp.asarray(alpha, jnp.float32)
    Fr, ar = _rep_params2(F, alpha, prep2)
    A = _k_transfer(F.shape[0], prep2)(*_streams(prep2, fc), Fr, ar)
    return _unpack_A2(A, prep2), (Fr, ar)


def transfer_grad_fused(F, alpha, prep2, fc):
    """Fused transfer+tangent stream for F/alpha [N]: A_g [nb, 13, 1,
    N] (rows 0:4 primal, 4:8 dF, 8:12 dalpha, 12 log-offset)."""
    f32 = jnp.float32
    Fr, ar = _rep_params2(F[None, :].astype(f32), alpha[None, :].astype(f32),
                          prep2)
    out = _k_transfer_grad(prep2)(*_streams(prep2, fc), Fr[0], ar[0])
    return _unpack_A2(out[:, None], prep2)


def forward_loglik_fused(F, alpha, prep2, fc):
    """Per-individual loglik; F/alpha [B, N] (B = candidates)."""
    A_r, _ = block_transfers_fused(F, alpha, prep2, fc)
    _, _, lls = _combine_blocks(A_r, jnp.asarray(F, jnp.float32))
    return lls[0]


def transfer_grad_reps_fused(F, alpha, prep2, fc):
    """ONE fused transfer+tangent stream serving BOTH the E-step and
    the M-step's first evaluation.

    Returns (A_g [nb, 13, 1, N], A_reps) where A_reps = (primal rows of
    A_g, lane-repeated params) is exactly block_transfers_fused's B=1
    output (the grad kernel's primal shares the transfer kernel's op
    order and rescale), so posteriors_fused(A_reps=...) reproduces the
    separate transfer pass's values while grad_from_carries_pallas(A_g,
    F) yields the M-step's first (value, gradient) with no extra
    stream."""
    F = jnp.asarray(F, jnp.float32)
    alpha = jnp.asarray(alpha, jnp.float32)
    A_g = transfer_grad_fused(F, alpha, prep2, fc)
    reps = _rep_params2(F[None], alpha[None], prep2)
    A_r = jnp.concatenate([A_g[:, 0:4], A_g[:, 12:13]], axis=1)
    return A_g, (A_r, reps)


def loglik_value_and_grad_fused(F, alpha, prep2, fc):
    """(ll, dL/dF, dL/dalpha), each [N]; F/alpha [N]."""
    A_g = transfer_grad_fused(F, alpha, prep2, fc)
    return grad_from_carries_pallas(A_g, F)


def posteriors_fused(F, alpha, prep2, fc, v0=None, wT=None, A_reps=None):
    """(p_ibd [S, N], ll_f [N], ll_b [N]); F/alpha [N].

    v0/wT [N, 2]: boundary carries when this slab is one segment of a
    longer chain (the lls are then segment-local values). A_reps:
    block_transfers_fused output to reuse (skips the transfer pass)."""
    F2, a2 = F[None, :], alpha[None, :]
    if A_reps is None:
        A_reps = block_transfers_fused(F2, a2, prep2, fc)
    A_r, reps = A_reps
    v0b = None if v0 is None else v0[None]
    wTb = None if wT is None else wT[None]
    starts, ends, lls = _combine_blocks(
        A_r, jnp.asarray(F2, jnp.float32), v0b, wTb
    )
    streams = _streams(prep2, fc)
    Fl, al = reps[0][0], reps[1][0]
    bwr = _k_bw(prep2)(*streams, Fl, al, *_ends_fold2(ends, prep2))
    p = _k_fw_post(prep2)(*streams, Fl, al, *_ends_fold2(starts, prep2), bwr)
    return _unpack_sites2(p, prep2), lls[0, 0], lls[1, 0]
