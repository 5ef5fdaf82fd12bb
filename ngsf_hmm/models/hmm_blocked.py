"""Blocked HMM kernels: sequential depth O(sqrt(S)) instead of O(S).

Why. The plain ``lax.scan`` recursions in hmm.py are mathematically right
but latency-bound on an accelerator when they are *composed* into larger
programs (an EM iteration, an L-BFGS line search): each of the S scan
steps does trivial elementwise work, so wall-clock is per-step overhead
x S. The two-state
transition is an associative operator in the (logsumexp, +) semiring
(reference recursion: shared/HMM.cpp:6-60), so the site dimension can be
re-associated: split S sites into nb blocks of bs, compute per-block 2x2
transfer matrices with a depth-bs scan that is VECTORIZED over all
blocks, combine the nb block matrices with a cheap depth-nb scan, then
recover per-site values with a second vectorized depth-bs scan. Total
sequential depth ~ 3*bs + 2*nb ~ O(sqrt(S)); every step does
[nb, n_ind]-wide elementwise work that fills the device.

Float32 strategy. Total log-likelihoods reach ~-1e5, where float32
resolution is ~1e-2 -- fatal for exp(fw + bw - L) posteriors computed
from independently-rounded blocked passes (the sequential scan survives
only because its roundings correlate). All carries here are therefore
max-normalised every step, and consumers never see absolute log
magnitudes:
 - the IBD posterior is sigmoid((fw1-fw0) + (bw1-bw0)): per-site
   normalisation constants cancel within a site;
 - the gradient's pairwise posteriors are renormalised per site by
   sum_kl u_kl T_kl (which is exactly 1 in infinite precision);
 - only the scalar log-likelihoods carry accumulated offsets (f32
   rounding ~1e-7 relative -- fine for the 1e-5-relative convergence
   gate, EM.cpp:56).

Layout. Blocked arrays put the within-block position FIRST so scans slice
contiguously: x_blk[i, j] = x[j * bs + i]   (i < bs, j < nb). Padding
sites (to a multiple of bs) use distance 0 => identity transition
(exp(-alpha*0) = 1, HMM.cpp:130-139) and log-emission 0, so they are
exact no-ops in every product. The blocking transpose is paid ONCE per
EM iteration (emissions are fixed across all M-step objective
evaluations), not once per evaluation.

Compat note: float64 + these kernels matches the sequential kernels to
~1e-10 (re-association rounding only); byte-parity golden runs use the
sequential hmm.py kernels.
"""

import math

import jax
import jax.numpy as jnp

from ..ops.logsum import logsum2
from ..ops.transitions import log_q


def pick_block_size(S):
    """Depth-minimising block size: min_bs (3*bs + 2*S/bs) ~ sqrt(2S/3)."""
    bs = int(math.sqrt(2.0 * max(S, 1) / 3.0))
    return max(8, min(bs, S if S > 0 else 8))


def block_sites(x, bs, pad_value):
    """[S, ...] -> ([bs, nb, ...], S). Pads the tail with pad_value."""
    S = x.shape[0]
    nb = -(-S // bs)
    pad = nb * bs - S
    if pad:
        pad_width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        x = jnp.pad(x, pad_width, constant_values=pad_value)
    x = x.reshape((nb, bs) + x.shape[1:])
    return jnp.swapaxes(x, 0, 1), S


def unblock_sites(x_blk, S):
    """[bs, nb, ...] -> [S, ...] inverse of block_sites."""
    x = jnp.swapaxes(x_blk, 0, 1)
    x = x.reshape((-1,) + x.shape[2:])
    return x[:S]


def _lt_elems(F, alpha, d):
    """Log transition entries for a [nb] slice: d [nb], F/alpha [N].

    Returns four [nb, N] arrays (same math as hmm._log_trans_elems;
    HMM.cpp:130-139, d=inf collapses to the stationary distribution).
    """
    d = d[:, None]
    is_break = jnp.isinf(d)
    d_safe = jnp.where(is_break, 1.0, d)
    x = jnp.where(is_break, 0.0, jnp.exp(-alpha[None, :] * d_safe))
    one_m = 1.0 - x
    lt00 = jnp.log(one_m * (1.0 - F)[None, :] + x)
    lt01 = jnp.log(one_m * F[None, :])
    lt10 = jnp.log(one_m * (1.0 - F)[None, :])
    lt11 = jnp.log(one_m * F[None, :] + x)
    return lt00, lt01, lt10, lt11


def _block_transfer(e_blk, dist_blk, F, alpha):
    """Normalised per-block transfer matrices via a depth-bs scan.

    A_j = M_{j,0} o M_{j,1} o ... in the (logsumexp, +) semiring, where
    M_s[k, l] = log T_s[k, l] + e_s[l]. The transition elements are
    computed on the fly from (e, dist) slices -- M is never materialised.

    Returns (A_n [nb, N, 2, 2], c [nb, N]) with true A = A_n + c and
    max(A_n) = 0 per (block, ind): the carry is re-normalised every step
    so float32 entries never accumulate magnitude.
    """
    nb, N = e_blk.shape[1], e_blk.shape[2]
    dtype = e_blk.dtype

    def step(carry, xs):
        c_mat, c_off = carry
        e_i, d_i = xs  # [nb, N, 2], [nb]
        lt00, lt01, lt10, lt11 = _lt_elems(F, alpha, d_i)
        m00 = lt00 + e_i[:, :, 0]
        m01 = lt01 + e_i[:, :, 1]
        m10 = lt10 + e_i[:, :, 0]
        m11 = lt11 + e_i[:, :, 1]
        c00 = logsum2(c_mat[..., 0, 0] + m00, c_mat[..., 0, 1] + m10)
        c01 = logsum2(c_mat[..., 0, 0] + m01, c_mat[..., 0, 1] + m11)
        c10 = logsum2(c_mat[..., 1, 0] + m00, c_mat[..., 1, 1] + m10)
        c11 = logsum2(c_mat[..., 1, 0] + m01, c_mat[..., 1, 1] + m11)
        mx = jnp.maximum(jnp.maximum(c00, c01), jnp.maximum(c10, c11))
        new = jnp.stack(
            [
                jnp.stack([c00 - mx, c01 - mx], -1),
                jnp.stack([c10 - mx, c11 - mx], -1),
            ],
            -2,
        )
        return (new, c_off + mx), None

    neg_inf = jnp.asarray(-jnp.inf, dtype)
    eye = jnp.stack(
        [
            jnp.stack([jnp.zeros((), dtype), neg_inf], -1),
            jnp.stack([neg_inf, jnp.zeros((), dtype)], -1),
        ],
        -2,
    )
    init = (
        jnp.broadcast_to(eye, (nb, N, 2, 2)),
        jnp.zeros((nb, N), dtype),
    )
    (A_n, c), _ = jax.lax.scan(step, init, (e_blk, dist_blk))
    return A_n, c


def _vecmat(v, A):
    """Row-vector o matrix in the log semiring: [.., 2] x [.., 2, 2]."""
    o0 = logsum2(v[..., 0] + A[..., 0, 0], v[..., 1] + A[..., 1, 0])
    o1 = logsum2(v[..., 0] + A[..., 0, 1], v[..., 1] + A[..., 1, 1])
    return jnp.stack([o0, o1], -1)


def _matvec(A, v):
    """Matrix o column-vector: [.., 2, 2] x [.., 2]."""
    o0 = logsum2(A[..., 0, 0] + v[..., 0], A[..., 0, 1] + v[..., 1])
    o1 = logsum2(A[..., 1, 0] + v[..., 0], A[..., 1, 1] + v[..., 1])
    return jnp.stack([o0, o1], -1)


def _renorm(v):
    """Subtract the per-row max of a [..., 2] log vector; return (v_n, m)."""
    m = jnp.maximum(v[..., 0], v[..., 1])
    return v - m[..., None], m


def _fw_block_starts(A_n, c, F):
    """Normalised forward carries at block starts.

    Returns (starts_n [nb, N, 2], ll_f [N]): starts_n[j] is the forward
    vector entering block j, max-normalised per (block, ind); ll_f is the
    total forward log-likelihood (offsets re-folded).
    """
    N = A_n.shape[1]
    lq = jnp.broadcast_to(log_q(F), (N, 2))

    def step(carry, xs):
        v_n, off = carry
        A_j, c_j = xs
        raw = _vecmat(v_n, A_j)
        new_n, m = _renorm(raw)
        return (new_n, off + m + c_j), v_n

    init = (lq, jnp.zeros((N,), A_n.dtype))
    (final_n, final_off), starts_n = jax.lax.scan(step, init, (A_n, c))
    ll_f = logsum2(final_n[:, 0], final_n[:, 1]) + final_off
    return starts_n, ll_f


def _bw_block_ends(A_n, c, F):
    """Normalised backward values at block ends.

    Returns (ends_n [nb, N, 2], ll_b [N]): ends_n[j] is the backward
    vector at the LAST site of block j (max-normalised); ll_b is the
    backward-side total log-likelihood (EM.cpp:166-170 consistency pair).
    """
    nb, N = A_n.shape[0], A_n.shape[1]
    zero = jnp.zeros((N, 2), A_n.dtype)

    def step(carry, xs):
        w_n, off = carry
        A_j, c_j = xs
        raw = _matvec(A_j, w_n)
        new_n, m = _renorm(raw)
        return (new_n, off + m + c_j), w_n

    init = (zero, jnp.zeros((N,), A_n.dtype))
    (bw_m1_n, off), ends_n = jax.lax.scan(
        step, init, (A_n, c), reverse=True
    )
    lq = log_q(F)
    ll_b = (
        logsum2(lq[:, 0] + bw_m1_n[:, 0], lq[:, 1] + bw_m1_n[:, 1]) + off
    )
    return ends_n, ll_b


def forward_loglik_blocked(F, alpha, e_blk, dist_blk):
    """Total per-individual log-likelihood from blocked inputs.

    Equivalent to hmm.forward_loglik (HMM.cpp:6-28 + logsum of row S) at
    sequential depth bs + nb. This is the L-BFGS line-search objective;
    e_blk/dist_blk come from block_sites and are reused across evals.
    """
    A_n, c = _block_transfer(e_blk, dist_blk, F, alpha)
    _, ll_f = _fw_block_starts(A_n, c, F)
    return ll_f


def forward_backward_blocked(F, alpha, e_blk, dist_blk):
    """Per-site normalised forward/backward vectors, blocked layout.

    Returns (fw_prev_n, fw_n, bw_n, ll_f, ll_b):
      fw_prev_n [bs, nb, N, 2]: forward carry BEFORE absorbing site s
                                (log q at s=0), max-normalised per site;
      fw_n      [bs, nb, N, 2]: forward value AT site s, max-normalised;
      bw_n      [bs, nb, N, 2]: backward value at site s, max-normalised;
      ll_f/ll_b [N]: forward / backward total log-likelihoods.
    Normalisation constants are per (site, block, ind) and NOT returned:
    consumers must only use within-site state differences or per-site
    renormalised quantities (see module docstring).
    """
    A_n, c = _block_transfer(e_blk, dist_blk, F, alpha)
    starts_n, ll_f = _fw_block_starts(A_n, c, F)
    ends_n, ll_b = _bw_block_ends(A_n, c, F)

    def fw_step(v_n, xs):
        e_i, d_i = xs
        lt00, lt01, lt10, lt11 = _lt_elems(F, alpha, d_i)
        n0 = logsum2(v_n[..., 0] + lt00, v_n[..., 1] + lt10) + e_i[:, :, 0]
        n1 = logsum2(v_n[..., 0] + lt01, v_n[..., 1] + lt11) + e_i[:, :, 1]
        new_n, _ = _renorm(jnp.stack([n0, n1], -1))
        return new_n, (v_n, new_n)

    final_n, (fw_prev_n, fw_n) = jax.lax.scan(
        fw_step, starts_n, (e_blk, dist_blk)
    )

    def bw_step(w_n, xs):
        e_i, d_i = xs
        lt00, lt01, lt10, lt11 = _lt_elems(F, alpha, d_i)
        b0 = logsum2(
            lt00 + e_i[:, :, 0] + w_n[..., 0], lt01 + e_i[:, :, 1] + w_n[..., 1]
        )
        b1 = logsum2(
            lt10 + e_i[:, :, 0] + w_n[..., 0], lt11 + e_i[:, :, 1] + w_n[..., 1]
        )
        new_n, _ = _renorm(jnp.stack([b0, b1], -1))
        return new_n, w_n

    # Processing site s turns bw_s into bw_{s-1}; the reverse scan's
    # carry INTO step s is bw_s. Carry entering block j is ends_n[j]
    # (the backward value at its last site)... but the scan needs the
    # per-block initial carry, which lax.scan cannot vary per block --
    # so the within-block reverse scan runs with ends_n as a batched
    # initial carry over the nb axis, exactly like the forward pass.
    _, bw_n = jax.lax.scan(bw_step, ends_n, (e_blk, dist_blk), reverse=True)

    # fw at each block's LAST site is that block's end carry: for block j
    # it equals the next block's start... except normalisation constants
    # differ; the within-block scan already emitted fw_n for every site,
    # including the last (new_n at i = bs-1), so nothing to patch.
    del final_n
    return fw_prev_n, fw_n, bw_n, ll_f, ll_b


def posteriors_blocked(e_blk, dist_blk, F, alpha, S):
    """E-step IBD posterior in natural site order.

    p_ibd(s) = sigmoid((fw1 - fw0) + (bw1 - bw0)): the exact state-1
    marginal exp(fw1 + bw1 - L) given that the two state marginals sum to
    one -- per-site normalisation constants cancel in the differences, so
    float32 never sees O(1e5) log magnitudes (module docstring).
    Returns (p_ibd [S, N], ll_f [N], ll_b [N]).
    """
    _, fw_n, bw_n, ll_f, ll_b = forward_backward_blocked(
        F, alpha, e_blk, dist_blk
    )
    d = (fw_n[..., 1] - fw_n[..., 0]) + (bw_n[..., 1] - bw_n[..., 0])
    p_blk = jax.nn.sigmoid(d)
    return unblock_sites(p_blk, S), ll_f, ll_b


# ---------------------------------------------------------------------------
# Linear-space scaled variants ("linear" numerics mode).
#
# The log-semiring kernels above spend ~16 logsumexp ops (exp/exp/log each)
# per site per individual and are transcendental-bound on the device. The
# classic scaled-HMM alternative works in probability space with per-step
# max renormalisation: 2x2 products become pure mul/add, and the only
# transcendentals left are ONE log per (site, ind) to rebuild the total
# log-likelihood from the accumulated scale factors (deferred and
# vectorised), plus none at all in the gradient/posterior paths, which
# consume per-site renormalised ratios. Emissions arrive in LINEAR space
# (e_lin = exp(log emissions), or emission_probs_linear directly).
# ---------------------------------------------------------------------------


_TINY = 1e-30  # renormalisation floor: degenerate all-zero chains stay finite


def _t_elems(F, alpha, d):
    """Linear transition entries for a [nb] slice: four [nb, N] arrays."""
    d = d[:, None]
    is_break = jnp.isinf(d)
    d_safe = jnp.where(is_break, 1.0, d)
    x = jnp.where(is_break, 0.0, jnp.exp(-alpha[None, :] * d_safe))
    one_m = 1.0 - x
    t00 = one_m * (1.0 - F)[None, :] + x
    t01 = one_m * F[None, :]
    t10 = one_m * (1.0 - F)[None, :]
    t11 = one_m * F[None, :] + x
    return t00, t01, t10, t11


def _block_transfer_lin(e_blk, dist_blk, F, alpha):
    """Linear normalised block transfer matrices + per-step scale logs.

    Returns (A [nb, N, 2, 2] with max entry 1, log_norm [nb, N] = sum of
    log scale factors): true transfer = A * exp(log_norm). The scales are
    emitted per step and log-summed once afterwards -- one log per
    (site, ind) total, vs ~16 logsumexp in the log-semiring kernel.
    """
    nb, N = e_blk.shape[1], e_blk.shape[2]
    dtype = e_blk.dtype

    def step(c, xs):
        e_i, d_i = xs
        t00, t01, t10, t11 = _t_elems(F, alpha, d_i)
        m00 = t00 * e_i[:, :, 0]
        m01 = t01 * e_i[:, :, 1]
        m10 = t10 * e_i[:, :, 0]
        m11 = t11 * e_i[:, :, 1]
        c00 = c[..., 0, 0] * m00 + c[..., 0, 1] * m10
        c01 = c[..., 0, 0] * m01 + c[..., 0, 1] * m11
        c10 = c[..., 1, 0] * m00 + c[..., 1, 1] * m10
        c11 = c[..., 1, 0] * m01 + c[..., 1, 1] * m11
        mx = jnp.maximum(jnp.maximum(c00, c01), jnp.maximum(c10, c11))
        mx = jnp.maximum(mx, _TINY)  # degenerate all-zero guard
        inv = 1.0 / mx
        new = jnp.stack(
            [
                jnp.stack([c00 * inv, c01 * inv], -1),
                jnp.stack([c10 * inv, c11 * inv], -1),
            ],
            -2,
        )
        return new, mx

    eye = jnp.eye(2, dtype=dtype)
    init = jnp.broadcast_to(eye, (nb, N, 2, 2))
    A, scales = jax.lax.scan(step, init, (e_blk, dist_blk))  # scales [bs,nb,N]
    log_norm = jnp.log(scales).sum(0)
    return A, log_norm


def fold_transfer_lin(A, log_norm):
    """Collapse per-block transfer matrices to ONE normalised matrix.

    Returns (T [N, 2, 2] with max entry 1, log_scale [N]): the transfer
    product of the whole segment. This is the quantity exchanged across
    site-sharded devices (parallel/site_sharded.py): a shard's entire
    contribution to the chain is its 2x2 transfer product.
    """
    N = A.shape[1]

    def step(carry, xs):
        c, off = carry
        a, ln = xs
        n00 = c[..., 0, 0] * a[..., 0, 0] + c[..., 0, 1] * a[..., 1, 0]
        n01 = c[..., 0, 0] * a[..., 0, 1] + c[..., 0, 1] * a[..., 1, 1]
        n10 = c[..., 1, 0] * a[..., 0, 0] + c[..., 1, 1] * a[..., 1, 0]
        n11 = c[..., 1, 0] * a[..., 0, 1] + c[..., 1, 1] * a[..., 1, 1]
        m = jnp.maximum(jnp.maximum(n00, n01), jnp.maximum(n10, n11))
        m = jnp.maximum(m, _TINY)
        inv = 1.0 / m
        new = jnp.stack(
            [jnp.stack([n00 * inv, n01 * inv], -1),
             jnp.stack([n10 * inv, n11 * inv], -1)], -2)
        return (new, off + jnp.log(m) + ln), None

    eye = jnp.broadcast_to(jnp.eye(2, dtype=A.dtype), (N, 2, 2))
    (T, off), _ = jax.lax.scan(step, (eye, jnp.zeros((N,), A.dtype)),
                               (A, log_norm))
    return T, off


def _fw_block_starts_lin(A, log_norm, F, v0=None):
    """Linear forward carries at block starts + total log-likelihood.

    v0: optional [N, 2] normalised boundary carry entering the segment
    (site-sharded runs; defaults to the stationary q(F))."""
    N = A.shape[1]
    q = jnp.stack([1.0 - F, F], -1) if v0 is None else v0  # [N, 2]

    def step(carry, xs):
        v, off = carry
        A_j, ln_j = xs
        r0 = v[..., 0] * A_j[..., 0, 0] + v[..., 1] * A_j[..., 1, 0]
        r1 = v[..., 0] * A_j[..., 0, 1] + v[..., 1] * A_j[..., 1, 1]
        m = jnp.maximum(r0, r1)
        m = jnp.maximum(m, _TINY)
        inv = 1.0 / m
        return (jnp.stack([r0 * inv, r1 * inv], -1), off + jnp.log(m) + ln_j), v

    init = (q, jnp.zeros((N,), A.dtype))
    (final, off), starts = jax.lax.scan(step, init, (A, log_norm))
    ll_f = jnp.log(final[:, 0] + final[:, 1]) + off
    return starts, ll_f


def _bw_block_ends_lin(A, log_norm, F, wT=None):
    """Linear backward values at block ends + backward-side loglik.

    wT: optional [N, 2] normalised backward boundary carry entering from
    the right (site-sharded runs; defaults to ones)."""
    nb, N = A.shape[0], A.shape[1]
    one = jnp.ones((N, 2), A.dtype) if wT is None else wT

    def step(carry, xs):
        w, off = carry
        A_j, ln_j = xs
        r0 = A_j[..., 0, 0] * w[..., 0] + A_j[..., 0, 1] * w[..., 1]
        r1 = A_j[..., 1, 0] * w[..., 0] + A_j[..., 1, 1] * w[..., 1]
        m = jnp.maximum(r0, r1)
        m = jnp.maximum(m, _TINY)
        inv = 1.0 / m
        return (jnp.stack([r0 * inv, r1 * inv], -1), off + jnp.log(m) + ln_j), w

    init = (one, jnp.zeros((N,), A.dtype))
    (bw_m1, off), ends = jax.lax.scan(step, init, (A, log_norm), reverse=True)
    ll_b = jnp.log((1.0 - F) * bw_m1[:, 0] + F * bw_m1[:, 1]) + off
    return ends, ll_b


def forward_loglik_blocked_lin(F, alpha, e_blk, dist_blk):
    """Per-individual log-likelihood; e_blk is LINEAR-space emissions."""
    A, log_norm = _block_transfer_lin(e_blk, dist_blk, F, alpha)
    _, ll_f = _fw_block_starts_lin(A, log_norm, F)
    return ll_f


def forward_backward_blocked_lin(F, alpha, e_blk, dist_blk, v0=None, wT=None,
                                 A_ln=None):
    """Per-site max-normalised linear fw/bw vectors, blocked layout.

    Returns (fw_prev, fw, bw, ll_f, ll_b) with vectors renormalised per
    site (consumers use within-site ratios only, like the log variant).
    v0/wT: optional [N, 2] boundary carries for site-sharded segments
    (ll_f/ll_b are then SEGMENT-local quantities; the caller owns the
    global likelihood). A_ln: optional precomputed
    _block_transfer_lin(e_blk, dist_blk, F, alpha) to avoid recomputing
    the depth-bs pass when the caller already ran it for these params.
    """
    A, log_norm = A_ln if A_ln is not None else _block_transfer_lin(
        e_blk, dist_blk, F, alpha
    )
    starts, ll_f = _fw_block_starts_lin(A, log_norm, F, v0=v0)
    ends, ll_b = _bw_block_ends_lin(A, log_norm, F, wT=wT)

    def fw_step(v, xs):
        e_i, d_i = xs
        t00, t01, t10, t11 = _t_elems(F, alpha, d_i)
        n0 = (v[..., 0] * t00 + v[..., 1] * t10) * e_i[:, :, 0]
        n1 = (v[..., 0] * t01 + v[..., 1] * t11) * e_i[:, :, 1]
        m = jnp.maximum(n0, n1)
        m = jnp.maximum(m, _TINY)
        inv = 1.0 / m
        new = jnp.stack([n0 * inv, n1 * inv], -1)
        return new, (v, new)

    _, (fw_prev, fw) = jax.lax.scan(fw_step, starts, (e_blk, dist_blk))

    def bw_step(w, xs):
        e_i, d_i = xs
        t00, t01, t10, t11 = _t_elems(F, alpha, d_i)
        b0 = t00 * e_i[:, :, 0] * w[..., 0] + t01 * e_i[:, :, 1] * w[..., 1]
        b1 = t10 * e_i[:, :, 0] * w[..., 0] + t11 * e_i[:, :, 1] * w[..., 1]
        m = jnp.maximum(b0, b1)
        m = jnp.maximum(m, _TINY)
        inv = 1.0 / m
        new = jnp.stack([b0 * inv, b1 * inv], -1)
        return new, w

    _, bw = jax.lax.scan(bw_step, ends, (e_blk, dist_blk), reverse=True)
    return fw_prev, fw, bw, ll_f, ll_b


def posteriors_blocked_lin(e_blk, dist_blk, F, alpha, S, v0=None, wT=None,
                           A_ln=None):
    """IBD posterior from linear-space blocked inputs, natural site order.

    p1 = fw1*bw1 / (fw0*bw0 + fw1*bw1): per-site scales cancel in the
    ratio; no transcendentals at all on this path. v0/wT/A_ln:
    site-sharded boundary carries / precomputed block transfers (see
    forward_backward_blocked_lin).
    """
    _, fw, bw, ll_f, ll_b = forward_backward_blocked_lin(
        F, alpha, e_blk, dist_blk, v0=v0, wT=wT, A_ln=A_ln
    )
    n1 = fw[..., 1] * bw[..., 1]
    n0 = fw[..., 0] * bw[..., 0]
    p_blk = n1 / (n0 + n1)
    return unblock_sites(p_blk, S), ll_f, ll_b


def loglik_value_and_grad_blocked_lin(F, alpha, e_blk, dist_blk, v0=None,
                                      wT=None, with_init_term=True,
                                      A_ln=None):
    """Analytic (loglik, dL/dF, dL/dalpha) from linear blocked inputs.

    Identical math to loglik_value_and_grad_blocked with u_kl built from
    linear products fw_prev[k]*e[l]*bw[l], renormalised per site via
    sum_kl u_kl T_kl = 1 -- transcendental-free outside the loglik scales.
    v0/wT: site-sharded segments pass boundary carries.
    with_init_term: the initial-distribution dF term belongs to site 0 of
    the WHOLE chain -- site-sharded shards pass a traced 0/1 weight (only
    shard 0's is 1) instead of a Python bool. A_ln: precomputed block
    transfers (see forward_backward_blocked_lin).
    """
    fw_prev, _, bw, ll_f, ll_b = forward_backward_blocked_lin(
        F, alpha, e_blk, dist_blk, v0=v0, wT=wT, A_ln=A_ln
    )

    d = dist_blk[..., None]
    is_break = jnp.isinf(d)
    d_safe = jnp.where(is_break, 1.0, d)
    x = jnp.where(is_break, 0.0, jnp.exp(-alpha[None, None, :] * d_safe))
    dx = jnp.where(is_break, 0.0, d_safe * x)
    one_m = 1.0 - x
    Fb = F[None, None, :]
    T00 = one_m * (1.0 - Fb) + x
    T01 = one_m * Fb
    T10 = one_m * (1.0 - Fb)
    T11 = one_m * Fb + x

    eb = e_blk * bw  # [bs, nb, N, 2]
    u00 = fw_prev[..., 0] * eb[..., 0]
    u01 = fw_prev[..., 0] * eb[..., 1]
    u10 = fw_prev[..., 1] * eb[..., 0]
    u11 = fw_prev[..., 1] * eb[..., 1]
    denom = u00 * T00 + u01 * T01 + u10 * T10 + u11 * T11
    inv = 1.0 / denom
    u00, u01, u10, u11 = u00 * inv, u01 * inv, u10 * inv, u11 * inv

    gF = (one_m * (-u00 + u01 - u10 + u11)).sum((0, 1))
    ga = (dx * (Fb * (u01 - u00) + (1.0 - Fb) * (u10 - u11))).sum((0, 1))

    if with_init_term is not False:
        weight = 1.0 if with_init_term is True else with_init_term
        eb0 = eb[0, 0]  # [N, 2]
        w0 = T00[0, 0] * eb0[:, 0] + T01[0, 0] * eb0[:, 1]
        w1 = T10[0, 0] * eb0[:, 0] + T11[0, 0] * eb0[:, 1]
        tot = (1.0 - F) * w0 + F * w1
        gF = gF + weight * (w1 - w0) / tot
    return ll_f, gF, ga


def loglik_value_and_grad_blocked(F, alpha, e_blk, dist_blk):
    """Analytic (loglik, dL/dF, dL/dalpha) on blocked inputs.

    Same Fisher-identity math as hmm.loglik_value_and_grad (see its
    docstring for the derivation), evaluated entirely in blocked layout.
    The pairwise terms u_kl = exp(fw_prev[k] + e[l] + bw[l] - L) are
    computed from NORMALISED vectors and renormalised per site via
    sum_kl u_kl T_kl = 1, so no absolute log magnitude is ever
    exponentiated. Padding sites (d = 0 => x = 1) contribute exactly
    zero: the dF term carries a factor 1-x = 0 and the dalpha term a
    factor d*x = 0.
    """
    fw_prev_n, _, bw_n, ll_f, ll_b = forward_backward_blocked(
        F, alpha, e_blk, dist_blk
    )

    d = dist_blk[..., None]  # [bs, nb, 1]
    is_break = jnp.isinf(d)
    d_safe = jnp.where(is_break, 1.0, d)
    x = jnp.where(is_break, 0.0, jnp.exp(-alpha[None, None, :] * d_safe))
    dx = jnp.where(is_break, 0.0, d_safe * x)
    one_m = 1.0 - x
    Fb = F[None, None, :]
    T00 = one_m * (1.0 - Fb) + x
    T01 = one_m * Fb
    T10 = one_m * (1.0 - Fb)
    T11 = one_m * Fb + x

    # Unnormalised pairwise terms from normalised vectors (args <= ~0).
    b = e_blk + bw_n  # [bs, nb, N, 2]
    z00 = fw_prev_n[..., 0] + b[..., 0]
    z01 = fw_prev_n[..., 0] + b[..., 1]
    z10 = fw_prev_n[..., 1] + b[..., 0]
    z11 = fw_prev_n[..., 1] + b[..., 1]
    mz = jnp.maximum(jnp.maximum(z00, z01), jnp.maximum(z10, z11))
    u00 = jnp.exp(z00 - mz)
    u01 = jnp.exp(z01 - mz)
    u10 = jnp.exp(z10 - mz)
    u11 = jnp.exp(z11 - mz)
    # sum_kl u_kl T_kl == 1 in exact arithmetic; renormalise per site.
    denom = u00 * T00 + u01 * T01 + u10 * T10 + u11 * T11
    inv = 1.0 / denom
    u00, u01, u10, u11 = u00 * inv, u01 * inv, u10 * inv, u11 * inv

    gF = (one_m * (-u00 + u01 - u10 + u11)).sum((0, 1))
    ga = (dx * (Fb * (u01 - u00) + (1.0 - Fb) * (u10 - u11))).sum((0, 1))

    # Initial-distribution term (dq0/dF = -1, dq1/dF = +1), site (0, 0):
    # w_k = sum_l T_0[k,l] exp(e_0[l] + bw_0[l] - L), renormalised via
    # q0 w0 + q1 w1 = 1.
    eb0 = jnp.exp(b[0, 0] - jnp.max(b[0, 0], axis=-1, keepdims=True))
    w0 = T00[0, 0] * eb0[:, 0] + T01[0, 0] * eb0[:, 1]
    w1 = T10[0, 0] * eb0[:, 0] + T11[0, 0] * eb0[:, 1]
    tot = (1.0 - F) * w0 + F * w1
    gF = gF + (w1 - w0) / tot
    return ll_f, gF, ga
