"""Streaming EM: genotype likelihoods larger than device memory.

The BASELINE 50M-site configs cannot hold gl [S, N, 3] (nor e_prob) on
one card. This runner keeps gl on the HOST (array, memmap, or a loader
callable) and streams site-chunks through the device per pass, using the
same boundary-carry algebra as cross-chip site sharding
(parallel/site_sharded.py): a chunk's entire effect on the chain is its
normalised 2x2 transfer product, so

  pass A  stream chunks -> per-chunk transfer products (tiny);
          host prefix/suffix -> per-chunk boundary carries + global ll
  pass B  stream chunks -> posteriors (with carries) -> chunk-local
          est_maf -> new freq; p_ibd chunks optionally written to host
  M-step  host-driven projected L-BFGS on (F, alpha): every evaluation
          (speculative full step + interpolated backtracking probes)
          streams the data ONCE for the fused objective+gradient -- the
          chunk transfer products AND their forward-mode parameter
          tangents come out of one pass; the host assembles carries and
          the Fisher-identity gradient from the tiny 2x2 algebra
          (emissions are a function of freq, never materialised whole)

With --kernel pallas (single-device streams) every chunk chain pass
above runs the Triton GL-fused kernels (models/hmm_pallas.py): the
fused transfer+tangent stream and the carry-conditioned posteriors;
the chunk-local est_maf is the XLA fixed point (ops/maf.py).

Per EM iteration: 2 + ~lbfgs_evals full streams. Correctness is pinned
against the monolithic engine on small data (tests/test_streaming.py).

The (F, alpha) M-step reuses models/lbfgsb.py's single algorithm core
through its NumPy/Python-loop backend (lbfgsb_minimize_host).
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.emissions import emission_probs_linear
from ..ops.hwe import check_interv
from ..ops.maf import est_maf
from ..utils.constants import ALPHA_MAX, ALPHA_MIN, F_MAX, F_MIN
from .em import EMOptions
from .hmm_blocked import (
    _block_transfer_lin,
    block_sites,
    fold_transfer_lin,
    pick_block_size,
    posteriors_blocked_lin,
)
from .lbfgsb import lbfgsb_minimize_host


# ---------------------------------------------------------------------------
# jitted per-chunk kernels (compiled once per chunk shape)
# ---------------------------------------------------------------------------


def _prep_chunk(gl_c, freq_c, dist_c, bs, valid):
    """Device: linear emissions from freq + blocked layout.

    Sites >= valid are the last chunk's padding: their emissions are
    forced to 1 (the identity no-op; padded GLs cannot express that --
    uniform likelihoods give e = 1/3 and each pad site would wrongly
    multiply the chain by 1/3)."""
    gl_lin = jnp.exp(gl_c)
    e_lin = emission_probs_linear(gl_lin, freq_c[:, None]).astype(jnp.float32)
    pad_mask = (jnp.arange(e_lin.shape[0]) >= valid)[:, None, None]
    e_lin = jnp.where(pad_mask, 1.0, e_lin)
    e_blk, _ = block_sites(e_lin, bs, 1.0)
    d_blk, _ = block_sites(dist_c.astype(jnp.float32), bs, 0.0)
    return gl_lin, e_blk, d_blk


from functools import partial


@partial(jax.jit, static_argnames=("cs",))
def _freq_slice_dev(freq_dev, lo, cs):
    return jax.lax.dynamic_slice(freq_dev, (jnp.asarray(lo),), (cs,))


@jax.jit
def _concat_dev(*chunks):
    return jnp.concatenate(chunks)


@jax.jit
def _stack_dev(*xs):
    return jnp.stack(xs)


@jax.jit
def _flat_concat(*xs):
    return jnp.concatenate([x.reshape(-1) for x in xs])


@partial(jax.jit, static_argnames=("bs2", "nb_p", "bf16"))
def _chunk_glslabs(gl_c, bs2, nb_p, bf16=False):
    """gl slabs for one chunk: (g0, g2) [bs, N * nb_p]. Constants of
    the run (gl never changes) -- cached per chunk when the device
    memory budget allows, else rebuilt per pass. Pad-cell gl bytes are
    irrelevant: the freq-compact sentinel forces pad emissions to
    exactly 1. bf16: store the slabs bfloat16 (half the slab and stream
    bytes; the kernels upcast at load -- hmm_pallas.gl_slabs)."""
    from . import hmm_pallas

    return hmm_pallas.gl_slabs(
        jnp.exp(gl_c), bs2, nb_p,
        dtype=jnp.bfloat16 if bf16 else jnp.float32,
    )


@partial(jax.jit, static_argnames=("bs2", "nb_p"))
def _chunk_fcomp(freq_c, bs2, nb_p, valid):
    """freq compact for one chunk; sites >= valid get the sentinel
    (emissions forced to 1: the last-chunk padding no-op)."""
    from . import hmm_pallas

    return hmm_pallas.site_compact(freq_c, bs2, nb_p, 2.0, valid=valid)


@partial(jax.jit, static_argnames=("bs2", "nb_p"))
def _chunk_dcomp(dist_c, bs2, nb_p):
    """dist compact for one chunk (run constant, tiny)."""
    from . import hmm_pallas

    return hmm_pallas.site_compact(dist_c, bs2, nb_p, 0.0)


@partial(jax.jit, static_argnames=("bs", "valid", "chain_kernel"))
def _chunk_eslabs(gl_c, freq_c, bs, valid, chain_kernel="blocked"):
    """The (gl, freq)-only half of chunk prep: emission slabs for the
    blocked (XLA) chain tier. Within one EM iteration, pass A, pass
    B's chain and EVERY M-step line-search eval need the same-math
    slabs from the same freq -- StreamingEM caches this output per
    (chunk, freq identity) so those passes skip the emission math +
    relayout AND the chunk-source gl fetch itself (a disk read for
    --stream_file). Cached and uncached passes compute identical MATH;
    bitwise equality additionally depends on XLA choosing the same
    fusion for this standalone jit as for _prep_chunk inlined into the
    pass kernels (holds on the CPU x64 test path, where it is gated by
    tests; treat as memoisation, not a bit-identity guarantee, on
    other backends).
    Same masking as _prep_chunk/_prep_chunk_slabs: pad sites (>= valid)
    get exact-identity emissions."""
    gl_lin = jnp.exp(gl_c)
    e_lin = emission_probs_linear(gl_lin, freq_c[:, None]).astype(jnp.float32)
    pad_mask = (jnp.arange(e_lin.shape[0]) >= valid)[:, None, None]
    e_lin = jnp.where(pad_mask, 1.0, e_lin)
    e_blk, _ = block_sites(e_lin, bs, 1.0)
    return (e_blk,)


@partial(jax.jit, static_argnames=("bs", "N", "chain_kernel"))
def _chunk_dslab(dist_c, bs, N, chain_kernel="blocked"):
    """The dist-only half of chunk prep -- a constant of the whole run
    (cached per chunk for the run's lifetime when the HBM budget
    allows)."""
    d_blk, _ = block_sites(dist_c.astype(jnp.float32), bs, 0.0)
    return d_blk


def _pre_prep(pre, dist_c, bs, cs, N, chain_kernel):
    """Assemble kernel-ready prep from cached slabs (traced context).

    chain_kernel "fused": pre = (g0, g2, dc, fc) slabs/compacts, bs =
    the (bs2, nb_p) geometry pair -> (prep2 dict, fc).
    "blocked": pre = (e_blk, d_blk); the d member is None when only the
    emission slabs are cached (then the dist slab is rebuilt in-traced
    from the tiny [cs] dist vector)."""
    if chain_kernel == "fused":
        from . import hmm_pallas

        g0, g2, dc, fc = pre
        bs2, nb_p = bs
        if dc is None:
            dc = hmm_pallas.site_compact(
                dist_c.astype(jnp.float32), bs2, nb_p, 0.0
            )
        return hmm_pallas.make_prep2(g0, g2, dc, cs, N, bs2, nb_p), fc
    e_blk, d_blk = pre
    if d_blk is None:
        d_blk, _ = block_sites(dist_c.astype(jnp.float32), bs, 0.0)
    return e_blk, d_blk


@partial(jax.jit,
         static_argnames=("bs", "valid", "chain_kernel", "cs", "N"))
def _chunk_transfer(gl_c, freq_c, dist_c, F, alpha, bs, valid,
                    chain_kernel="blocked", pre=None, cs=None, N=None):
    """(T [N,2,2] normalised, s [N] log scale) for one chunk.

    pre: cached slabs from _chunk_eslabs/_chunk_dslab (then gl_c/freq_c
    are None and cs/N carry the chunk geometry statically). The fused
    tier ("fused") ALWAYS runs from pre = (g0, g2, dc, fc): one streamed
    pass over the gl slabs with in-kernel emissions -- no per-pass prep
    at all."""
    if chain_kernel == "fused":
        from . import hmm_pallas

        prep2, fc = _pre_prep(pre, dist_c, bs, cs, N, "fused")
        A_reps = hmm_pallas.block_transfers_fused(
            F[None], alpha[None], prep2, fc
        )
        T, s = hmm_pallas.fold_transfers_pallas(A_reps[0])
        return T[0], s[0]
    if pre is not None:
        e_blk, d_blk = _pre_prep(pre, dist_c, bs, cs, N, "blocked")
    else:
        _, e_blk, d_blk = _prep_chunk(gl_c, freq_c, dist_c, bs, valid)
    A, ln = _block_transfer_lin(e_blk, d_blk, F, alpha)
    return fold_transfer_lin(A, ln)


@partial(jax.jit,
         static_argnames=("bs", "S_c", "valid", "with_freq",
                          "chain_kernel", "cs", "N"))
def _chunk_estep(gl_c, freq_c, dist_c, F, alpha, v0, wT, bs, S_c, valid,
                 with_freq=True, chain_kernel="blocked",
                 pre=None, cs=None, N=None, areps=None):
    """Posteriors with boundary carries + chunk-local freq M-step.

    with_freq=False skips the est_maf fixed point (and its cross-ind
    psum on meshes): the final posterior-only pass after convergence.

    pre: cached emission/dist slabs -- the chain part then skips the
    prep; gl_c is still needed (and freq_c not) when with_freq=True
    (est_maf reads the raw GLs), and may be None otherwise.

    areps (fused tier): pass A's per-block primal transfer rows
    ([nb, 5, 1, N]) for this chunk at the SAME (freq, F, alpha) --
    posteriors then skip their own transfer sub-pass (bit-identical
    values, _chunk_transfer_grad docstring)."""
    if pre is not None:
        gl_lin = None if gl_c is None else jnp.exp(gl_c)
        if chain_kernel == "fused":
            from . import hmm_pallas

            prep2, fc = _pre_prep(pre, dist_c, bs, cs, N, "fused")
            A_reps = None
            if areps is not None:
                A_reps = (areps, hmm_pallas._rep_params2(
                    F[None].astype(jnp.float32),
                    alpha[None].astype(jnp.float32), prep2))
            p_raw, _, _ = hmm_pallas.posteriors_fused(
                F, alpha, prep2, fc,
                v0=v0.astype(jnp.float32), wT=wT.astype(jnp.float32),
                A_reps=A_reps,
            )
        else:
            e_blk, d_blk = _pre_prep(pre, dist_c, bs, cs, N, "blocked")
            p_raw, _, _ = posteriors_blocked_lin(
                e_blk, d_blk, F, alpha, S_c, v0=v0, wT=wT
            )
    else:
        gl_lin, e_blk, d_blk = _prep_chunk(gl_c, freq_c, dist_c, bs, valid)
        p_raw, _, _ = posteriors_blocked_lin(
            e_blk, d_blk, F, alpha, S_c, v0=v0, wT=wT
        )
    p_ibd = check_interv(p_raw)
    if not with_freq:
        return p_ibd, freq_c
    # streaming is always a linear speed tier: macro-stepping cuts the
    # fixed point ~5x (and, on mesh streams, the psum count ~7x)
    freq_new = est_maf(gl_lin, p_ibd, linear=True, macro=True)
    return p_ibd, freq_new


@partial(jax.jit,
         static_argnames=("bs", "valid", "chain_kernel", "cs", "N",
                          "return_areps"))
def _chunk_transfer_grad(gl_c, freq_c, dist_c, F, alpha, bs, valid,
                         chain_kernel="blocked", pre=None, cs=None, N=None,
                         return_areps=False):
    """ONE stream -> chunk transfer product AND its parameter tangents.

    return_areps (fused tier only): append the chunk's per-BLOCK primal
    transfer rows A_r [nb, 5, 1, N] (device-resident) -- pass B's
    posteriors reuse them via posteriors_fused(A_reps=...), skipping
    their own transfer sub-pass; the grad kernel's primal rows are the
    transfer kernel's bit-for-bit
    (hmm_pallas.transfer_grad_reps_fused docstring).

    chain_kernel="fused": the fused transfer+tangent Triton stream
    (hmm_pallas._k_transfer_grad) + the tangent-aware fold; the
    tangents share the primal's rescale, so they are returned as
    (dT, ds=0) -- exactly what the host's Fisher-ratio assembly
    (_grad_from_transfers) expects.

    Returns (T [N,2,2], s [N], dT_F, ds_F, dT_a, ds_a): forward-mode
    tangents of the (normalised T, log-scale s) pair w.r.t. each
    individual's F / alpha (individuals are independent, so a single
    all-ones tangent per parameter yields every per-ind derivative).
    The true chunk matrix is M = T e^s, so dM = (dT + T ds) e^s -- the
    e^s cancels in the host's Fisher-identity ratio. jax.linearize runs
    the primal fold ONCE and applies the linearized scan per tangent
    (two jvp calls would each re-run the primal: XLA cannot CSE two
    augmented scans whose carries differ), so this costs ~1 primal + 2
    tangent sweeps, all in the SAME data stream that previously only
    produced (T, s)."""
    if chain_kernel == "fused":
        from . import hmm_pallas

        prep2, fc = _pre_prep(pre, dist_c, bs, cs, N, "fused")
        A_g = hmm_pallas.transfer_grad_fused(F, alpha, prep2, fc)
        T, s, DF, Da = hmm_pallas.fold_grad_pallas(A_g)
        z = jnp.zeros_like(s)
        if return_areps:
            A_r = jnp.concatenate([A_g[:, 0:4], A_g[:, 12:13]], axis=1)
            return T, s, DF, z, Da, z, A_r
        return T, s, DF, z, Da, z
    if pre is not None:
        e_blk, d_blk = _pre_prep(pre, dist_c, bs, cs, N, "blocked")
    else:
        _, e_blk, d_blk = _prep_chunk(gl_c, freq_c, dist_c, bs, valid)

    def f(F_, a_):
        A, ln = _block_transfer_lin(e_blk, d_blk, F_, a_)
        return fold_transfer_lin(A, ln)

    if return_areps:
        raise ValueError("return_areps requires the fused tier")
    (T, s), f_lin = jax.linearize(f, F, alpha)
    ones, zeros = jnp.ones_like(F), jnp.zeros_like(F)
    dT_F, ds_F = f_lin(ones, zeros)
    dT_a, ds_a = f_lin(zeros, ones)
    return T, s, dT_F, ds_F, dT_a, ds_a


# ---------------------------------------------------------------------------
# host-side chain assembly (tiny 2x2 algebra in float64)
# ---------------------------------------------------------------------------


def _assemble_chain(Ts, ss, F):
    """Prefix/suffix over [C] chunk transfers -> carries + global lls.

    Ts [C, N, 2, 2], ss [C, N] numpy. Returns (v0 [C, N, 2],
    wT [C, N, 2], ll_f [N], ll_b [N]).
    """
    C, N = Ts.shape[0], Ts.shape[1]
    Ts = Ts.astype(np.float64)
    ss = ss.astype(np.float64)
    q = np.stack([1.0 - F, F], -1)  # [N, 2]

    v0 = np.empty((C, N, 2))
    v = q.copy()
    off = np.zeros(N)
    for c in range(C):
        v0[c] = v
        r = np.einsum("nk,nkl->nl", v, Ts[c])
        m = np.maximum(r.max(-1), 1e-300)
        v = r / m[:, None]
        off += np.log(m) + ss[c]
    ll_f = np.log(v.sum(-1)) + off

    wT = np.empty((C, N, 2))
    w = np.ones((N, 2))
    offb = np.zeros(N)
    for c in range(C - 1, -1, -1):
        wT[c] = w
        r = np.einsum("nkl,nl->nk", Ts[c], w)
        m = np.maximum(r.max(-1), 1e-300)
        w = r / m[:, None]
        offb += np.log(m) + ss[c]
    ll_b = np.log((q * w).sum(-1)) + offb
    return v0, wT, ll_f, ll_b


def _grad_from_transfers(Ts, dT_F, ds_F, dT_a, ds_a, v0, wT):
    """Fisher-identity gradient from per-chunk transfer tangents.

    dll/dtheta = sum_c [v0_c . (dT_c + T_c ds_c) . wT_c] /
                       [v0_c . T_c . wT_c]
    (per-chunk e^s factors and carry normalisations cancel in each
    ratio, so the scale logs themselves are not needed), plus the
    initial-distribution term dq/dF = (-1, 1) applied to chunk 0's
    suffix -- q is already baked into v0[0], so F is not needed either
    (hmm_blocked.loglik_value_and_grad_blocked_lin:569-575 is the
    per-site form of the same identity).
    """
    C, N = Ts.shape[0], Ts.shape[1]
    gF = np.zeros(N)
    ga = np.zeros(N)
    for c in range(C):
        T = Ts[c].astype(np.float64)
        v, w = v0[c], wT[c]
        den = np.einsum("nk,nkl,nl->n", v, T, w)
        for dT, ds, out in (
            (dT_F[c], ds_F[c], gF),
            (dT_a[c], ds_a[c], ga),
        ):
            dM = dT.astype(np.float64) + T * ds.astype(np.float64)[:, None, None]
            out += np.einsum("nk,nkl,nl->n", v, dM, w) / den
        if c == 0:
            # init term: X_k = (T_0 . wT_0)_k, d log(q.X)/dF via dq
            X = np.einsum("nkl,nl->nk", T, w)
            gF += (X[:, 1] - X[:, 0]) / np.einsum("nk,nk->n", v0[0], X)
    return gF, ga


# ---------------------------------------------------------------------------
# the streaming runner
# ---------------------------------------------------------------------------


class StreamingEM:
    """EM over host-resident GLs streamed in site chunks.

    gl: [S, N, 3] float array-like on host (np.ndarray / np.memmap), log
        space, normalised (io/readers.py output).
    dist: [S] float64 Mb distances.
    chunk_sites: sites per device chunk (last chunk may be short but is
        padded to the same shape so every pass reuses ONE compiled
        kernel per function).
    mesh: optional (restart=1, ind) jax.sharding.Mesh -- each streamed
        chunk is placed with individuals sharded across the mesh, so the
        50M-site x 5000-ind BASELINE config streams host chunks through
        MANY chips at once (SURVEY.md §5.8 composition). Individuals are
        independent in the chain, so the only collective is the psum
        GSPMD inserts for est_maf's cross-individual accumulator sums in
        the chunk-local freq M-step; everything the host assembles
        (2x2 transfer products, carries) is per-individual and tiny.
        The mesh's ind axis must divide N.
    """

    def __init__(self, gl, dist, chunk_sites=1 << 20, mesh=None,
                 n_ind_total=None, device_freq="auto", slab_bf16="auto"):
        """Multi-process meshes: `gl` holds only THIS process's ind
        columns (each host streams its slab of every chunk) and
        `n_ind_total` gives the global individual count. All host math
        stays per-local-individual; device chunk arrays are assembled as
        global arrays from the per-process slabs, so est_maf's
        cross-individual sums become DCN collectives exactly as in the
        monolithic distributed path. Convergence control values are
        allgathered per iteration (tiny [N] vectors), keeping every
        process's host loop in lockstep.

        device_freq: keep the freq vector DEVICE-resident across the
        run (single-device streams only; "auto" = on when mesh is
        None). The host path pushes each chunk's [cs] freq slice h2d
        once per EM iteration (the _freq_dev cache dedups the per-pass
        re-puts) and pulls the chunk-local est_maf output back (d2h)
        per iteration -- transfers the device path eliminates entirely
        (freq is [C*cs] padded f32 on device, sliced on-device per
        chunk; the host sees it only at checkpoint cadence and at the
        end). Values are bit-identical: the host path stores the same
        f32 results through a float64 detour.

        slab_bf16: store the fused tier's per-chunk gl slabs in
        bfloat16 (half the slab HBM + stream bytes, so the pinned
        cache prefix roughly doubles on >HBM streams; gl quantised at
        ~2^-9 relative, kernel math stays f32). True/False force;
        "auto" (default) engages exactly when the f32 slabs would only
        PARTIALLY pin (0 < pin_k < C) -- fully-cacheable streams keep
        the f32 tier's exactness, cache-disabled runs stay f32 so
        NGSF_STREAM_CACHE_BYTES=0 remains a pure-memoisation switch.
        Env override: NGSF_STREAM_SLAB_BF16=0/1. Applies per chunk
        uniformly (cached and rebuilt chunks share one dtype), so the
        trajectory is deterministic for a given setting."""
        import os

        env_bf16 = os.environ.get("NGSF_STREAM_SLAB_BF16")
        if env_bf16 is not None:
            slab_bf16 = bool(int(env_bf16))
        self._slab_bf16_req = slab_bf16
        self._slab_dt = jnp.float32
        self.gl = gl
        self.S, self.N = gl.shape[0], gl.shape[1]
        self.N_tot = int(n_ind_total) if n_ind_total else self.N
        self.dist = np.asarray(dist, np.float64)
        self.cs = int(min(chunk_sites, self.S))
        self.C = -(-self.S // self.cs)
        self.bs = pick_block_size(self.cs)
        # chunk-kernel tier, set per run() from opts.numerics: _ck is
        # the chain_kernel and _cbs the matching block size
        self._ck = "blocked"
        self._cbs = self.bs
        self.mesh = mesh
        self.device_freq = (
            mesh is None if device_freq == "auto" else bool(device_freq)
        )
        if self.device_freq and mesh is not None:
            raise ValueError("device_freq is single-device only")
        # warm-started host L-BFGS memory (models/lbfgsb.py), threaded
        # across EM iterations; [m, N_loc, 2]-shaped, so multi-process
        # runs keep their own local-individual block
        self._opt_mem = None
        # Device caches for per-chunk inputs that are pass-invariant.
        # Distances never change: cache for the whole run (S x 4 B of
        # HBM). freq changes only BETWEEN EM iterations, but pass A,
        # pass B and every M-step line-search eval inside one iteration
        # re-push the same slice -- keyed on the freq object's identity
        # so a new freq vector invalidates the cache: each hit saves an
        # h2d copy + layout per chunk-pass.
        self._dist_cache = {}
        self._freq_key = None
        self._freq_cache = {}
        # Budget-gated SLAB caches (single-process, non-mesh streams;
        # planned per run() once the kernel tier fixes the slab
        # geometry -- see _plan_slab_caches):
        #   _eslab_cache: per (chunk, freq identity) emission slabs --
        #     pass A builds them (one gl fetch per chunk per EM
        #     iteration), then pass B's chain and every M-step
        #     line-search eval skip BOTH the chunk-source gl fetch and
        #     the emission+relayout prep.
        #   _dslab_cache: per-chunk dist slabs, constants of the run.
        self._eslab_cache = {}
        self._dslab_cache = {}
        # fused-tier caches: per-chunk dist/freq compacts (tiny --
        # always cached; fcomp rolls over per freq epoch)
        self._dcomp_cache = {}
        self._fcomp_cache = {}
        self._cache_e = False
        self._cache_d = False
        self._planned = False
        self.multi = mesh is not None and any(
            d.process_index != jax.process_index()
            for d in mesh.devices.flat
        )
        if not self.multi and self.N_tot != self.N:
            raise ValueError("n_ind_total only applies to multi-process "
                             "meshes")
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            n_sh = int(np.prod([mesh.shape[a] for a in mesh.axis_names
                                if a == "ind"]))
            if self.N_tot % max(n_sh, 1) != 0:
                raise ValueError(
                    f"n_ind {self.N_tot} not divisible by mesh ind axis "
                    f"{n_sh}"
                )
            self._sh = {
                # chunk-shaped [cs, ...] arrays: ind on axis 1
                "gl": NamedSharding(mesh, P(None, "ind", None)),
                # per-individual vectors/stacks: ind on the LAST axis
                # ([N], [K, N]) or first-of-two ([N, 2])
                "ind": NamedSharding(mesh, P("ind")),
                "kind": NamedSharding(mesh, P(None, "ind")),
                "ind2": NamedSharding(mesh, P("ind", None)),
                "rep": NamedSharding(mesh, P()),
            }
            self._ind_axis = {"gl": 1, "ind": 0, "kind": 1, "ind2": 0}

    def _put(self, x, kind, dtype=None):
        """Device placement: sharded onto the mesh, or plain asarray.

        Multi-process: ind-carrying kinds arrive as LOCAL slabs and are
        assembled into global arrays; "rep" kinds arrive identical on
        every process."""
        if self.multi:
            from ..parallel.distributed import global_from_slab

            x = np.asarray(x, dtype)
            ax = self._ind_axis.get(kind)
            gshape = list(x.shape)
            if ax is not None:
                gshape[ax] = self.N_tot
            return global_from_slab(self._sh[kind], x, tuple(gshape))
        x = jnp.asarray(x, dtype)
        if self.mesh is None:
            return x
        return jax.device_put(x, self._sh[kind])

    def _loc(self, x, axis=0):
        """Kernel output -> this process's local ind block (host np)."""
        if not self.multi:
            return np.asarray(x)
        from ..parallel.distributed import local_slab

        return local_slab(x, axis)

    def _rep(self, x):
        """Kernel output with no ind axis -> full host copy."""
        if not self.multi:
            return np.asarray(x)
        from ..parallel.distributed import host_array

        return host_array(x)

    def _gather_ind(self, vec):
        """[N_loc] local per-ind vector -> [N_tot] global, identical on
        every process (an allgather: LOCKSTEP on all processes)."""
        if not self.multi:
            return np.asarray(vec)
        from ..parallel.distributed import global_from_slab, host_array

        g = global_from_slab(
            self._sh["ind"], np.ascontiguousarray(vec), (self.N_tot,)
        )
        return host_array(g)

    def _chunk(self, c):
        """Padded chunk c: (gl_c [cs, N, 3] f32, freq slice idx, dist_c)."""
        lo = c * self.cs
        hi = min(lo + self.cs, self.S)
        gl_c = np.asarray(self.gl[lo:hi], np.float32)
        d_c = self.dist[lo:hi].astype(np.float32)
        if hi - lo < self.cs:
            pad = self.cs - (hi - lo)
            # pad: uniform GLs + zero distance = identity transitions
            gl_c = np.pad(gl_c, ((0, pad), (0, 0), (0, 0)),
                          constant_values=np.float32(np.log(1 / 3)))
            d_c = np.pad(d_c, (0, pad), constant_values=0.0)
        return gl_c, lo, hi, d_c

    def _freq_chunk(self, freq, lo, hi):
        """Chunk c's freq slice, padded to cs.

        `freq` is either a host [S] vector, or (device_freq runs) the
        PADDED [C*cs] f32 device vector -- then the slice stays on
        device (chunks are cs-aligned, so a plain dynamic_slice works
        pad included)."""
        if isinstance(freq, jnp.ndarray) and not isinstance(
            freq, np.ndarray
        ):
            return _freq_slice_dev(freq, lo, self.cs)
        f = freq[lo:hi].astype(np.float32)
        if hi - lo < self.cs:
            f = np.pad(f, (0, self.cs - (hi - lo)), constant_values=0.25)
        return f

    def _dist_c(self, c):
        """Chunk c's padded [cs] f32 distance vector (host)."""
        lo = c * self.cs
        hi = min(lo + self.cs, self.S)
        d_c = self.dist[lo:hi].astype(np.float32)
        if hi - lo < self.cs:
            d_c = np.pad(d_c, (0, self.cs - (hi - lo)),
                         constant_values=0.0)
        return d_c

    def _dist_dev(self, c, d_c=None):
        """Device-resident distance chunk c (cached across passes AND
        EM iterations -- distances are constants of the run)."""
        out = self._dist_cache.get(c)
        if out is None:
            out = self._put(self._dist_c(c) if d_c is None else d_c,
                            "rep")
            self._dist_cache[c] = out
        return out

    def _freq_epoch(self, freq):
        """Invalidate the freq-keyed caches when the freq vector
        changes (each EM iteration produces a NEW freq object). The
        fused tier's gl slabs are freq-INDEPENDENT run constants --
        only its freq compacts roll over."""
        if self._freq_key is not freq:
            self._freq_key = freq
            self._freq_cache = {}
            self._fcomp_cache = {}
            if self._ck != "fused":
                self._eslab_cache = {}

    def _freq_dev(self, freq, c, lo, hi):
        """Device-resident freq chunk c for the CURRENT freq vector.

        Every pass of one EM iteration (chain, posteriors, each M-step
        eval) shares the same freq, so its chunk slices are pushed
        once; identity of `freq` is the cache key (a new iteration's
        vector is a new object). device_freq runs slice on-device
        already -- the cache just memoises the slice."""
        self._freq_epoch(freq)
        out = self._freq_cache.get(c)
        if out is None:
            out = self._put(self._freq_chunk(freq, lo, hi), "rep")
            self._freq_cache[c] = out
        return out

    def _slab_bytes(self):
        """(cached-slab bytes, d-slab bytes) per chunk for the active
        tier: (gl slabs, dist compact) fused / (e slabs, d blocks)
        blocked."""
        if self._ck == "fused":
            from . import hmm_pallas

            bs2, nb_p = self._cbs
            _, L, _ = hmm_pallas._geom2(self.cs, self.N, bs2, nb_p)
            isz = jnp.dtype(self._slab_dt).itemsize
            return 2 * bs2 * L * isz, bs2 * nb_p * 4
        cs_pad = -(-self.cs // self._cbs) * self._cbs
        return cs_pad * self.N * 2 * 4, cs_pad * 4

    def _plan_slab_caches(self):
        """Decide, from an HBM budget, how many chunks' prepped
        emission / dist slabs stay device-resident across chunk passes.

        An LRU-style partial cache would always evict before reuse (the
        pass order cycles 0..C-1), so the cache PINS a fixed prefix of
        chunks [0, pin_k): those never rebuild, the rest always do --
        at 50M x 100 the slabs exceed HBM several times over and
        pinning the prefix still saves pin_k/C of every pass's prep.
        Budget: NGSF_STREAM_CACHE_BYTES env override (0 disables), else
        60% of the device's reported bytes_limit minus the per-pass
        working set. A device that reports no bytes_limit is an error
        (no size is assumed), except the CPU backend, which has no
        device memory of its own: there the cache stays off. Emission/gl
        slabs first
        (they save the gl fetch + emission math + relayout on every
        pass), the dist slabs only with a FULL pin (they are small and
        per-pass rebuilt-on-device anyway). Single-process, non-mesh
        streams only: the folded slab layouts interleave sites and
        individuals, so they have no clean mesh sharding."""
        import os

        self._cache_e = self._cache_d = False
        self._pin_k = 0
        self._eslab_cache = {}
        self._dslab_cache = {}
        self._dcomp_cache = {}
        self._fcomp_cache = {}
        if self.mesh is not None or self.multi:
            return
        raw = os.environ.get("NGSF_STREAM_CACHE_BYTES")
        e_b, d_b = self._slab_bytes()
        # per-pass working set the cache must leave room for: the gl
        # chunk h2d + slab-build temps + kernel workspace (ADVICE r3:
        # budgeting the cache against bytes_limit alone can OOM
        # mid-run). The temps are f32 regardless of the slab storage
        # dtype (exp(gl), fold transposes, upcast kernel blocks), so
        # the margin uses the F32 slab size even under bf16 slabs.
        isz = jnp.dtype(self._slab_dt).itemsize
        work = self.cs * self.N * 3 * 4 + 3 * (e_b * 4 // isz)
        if raw is not None:
            budget = int(raw)
        else:
            dev = jax.devices()[0]
            limit = (dev.memory_stats() or {}).get("bytes_limit")
            if limit is None and dev.platform != "cpu":
                raise RuntimeError(
                    f"{dev.platform} device reports no bytes_limit: set "
                    "NGSF_STREAM_CACHE_BYTES to size the slab cache"
                )
            budget = 0 if limit is None else int(limit * 0.6) - work
        self._pin_k = 0
        if budget <= 0 or e_b <= 0:
            return
        k = min(self.C, budget // e_b)
        if k >= 1:
            self._cache_e = True
            self._pin_k = int(k)
            budget -= self._pin_k * e_b
        if self._pin_k == self.C and self.C * d_b <= budget:
            self._cache_d = True

    def _config_kernel(self, opts):
        """Fix the chunk-kernel tier from opts and (re)plan the slab
        caches -- idempotent; called by run() and _stream_iteration so
        direct _stream_iteration drivers (bench, probes) get the same
        tier + caching as the product path.

        --kernel pallas on a single-device stream: every chunk chain
        pass (transfers, fused grad stream, posteriors) runs the Triton
        GL-fused kernels -- gl slabs are run constants (cached per
        chunk under the device memory budget, else rebuilt per pass),
        freq enters as a tiny per-site compact, emissions are computed
        in-kernel. Mesh streams keep the XLA tier
        (models.em.resolve_numerics)."""
        from .em import resolve_numerics

        tier, _ = resolve_numerics(opts.numerics, opts.freq_est,
                                   opts.e_prob_calc,
                                   mesh_stream=self.mesh is not None)
        ck = "fused" if tier == "pallas" else "blocked"
        if self._planned and ck == self._ck:
            return
        if ck == "fused":
            from . import hmm_pallas

            self._cbs = hmm_pallas.pick_geom2(self.cs, self.N)
        else:
            self._cbs = self.bs
        self._ck = ck
        self._slab_dt = jnp.float32
        self._plan_slab_caches()
        # bf16 slab tier (__init__ docstring): forced, or auto when the
        # f32 slabs only PARTIALLY pin -- then halve the per-chunk slab
        # footprint and replan (the pinned prefix roughly doubles)
        want = self._slab_bf16_req
        if ck == "fused" and (
            want is True
            or (want == "auto" and self._cache_e and self._pin_k < self.C)
        ):
            self._slab_dt = jnp.bfloat16
            self._plan_slab_caches()
            import sys

            print(
                f"[streaming] bf16 gl-slab tier on (pinning "
                f"{self._pin_k}/{self.C} chunks)",
                file=sys.stderr,
            )
        self._planned = True

    def _chunk_inputs(self, freq, c, need_gl=False):
        """Cache-aware kernel inputs for chunk c:
        (gl_d, freq_d, dist_d, pre, lo, hi).

        With slab caching on, `pre` holds the (e..., d) slabs, gl_d and
        freq_d are None (unless need_gl -- pass B's est_maf reads raw
        GLs) and the chunk source is NOT touched on cache hits.

        Fused tier: pre = (g0, g2, dc, fc) ALWAYS (slabs from the
        run-lifetime cache when budgeted, else rebuilt; dist/freq
        compacts always cached -- they are ~cs*4 bytes each)."""
        lo = c * self.cs
        hi = min(lo + self.cs, self.S)
        if self._ck == "fused":
            self._freq_epoch(freq)
            bs2, nb_p = self._cbs
            pin = self._cache_e and c < self._pin_k
            sl = self._eslab_cache.get(c) if pin else None
            gl_d = None
            if sl is None or need_gl:
                gl_c, lo, hi, _ = self._chunk(c)
                gl_d = self._put(gl_c, "gl")
            if sl is None:
                sl = _chunk_glslabs(
                    gl_d, bs2, nb_p, bf16=self._slab_dt == jnp.bfloat16
                )
                if pin:
                    try:
                        # materialise now: an over-optimistic budget
                        # must fail HERE, where we can fall back to
                        # uncached streaming, not later inside a pass
                        # kernel
                        for x in sl:
                            x.block_until_ready()
                        self._eslab_cache[c] = sl
                    except Exception as e:  # RESOURCE_EXHAUSTED et al.
                        if "RESOURCE_EXHAUSTED" not in str(e):
                            raise
                        import sys

                        kind = type(e).__name__
                        print(
                            "[streaming] gl-slab cache disabled: device "
                            f"OOM while caching chunk {c} ({kind})",
                            file=sys.stderr,
                        )
                        self._cache_e = self._cache_d = False
                        self._eslab_cache = {}
                        self._dslab_cache = {}
            fc = self._fcomp_cache.get(c)
            if fc is None:
                fc = _chunk_fcomp(
                    self._freq_dev(freq, c, lo, hi), bs2, nb_p, hi - lo
                )
                self._fcomp_cache[c] = fc
            dc = self._dcomp_dev(c)
            return (gl_d if need_gl else None, None, self._dist_dev(c),
                    (*sl, dc, fc), lo, hi)
        if not self._cache_e:
            gl_c, lo, hi, d_c = self._chunk(c)
            return (self._put(gl_c, "gl"),
                    self._freq_dev(freq, c, lo, hi),
                    self._dist_dev(c, d_c), None, lo, hi)
        self._freq_epoch(freq)
        es = self._eslab_cache.get(c) if c < self._pin_k else None
        gl_d = None
        if es is None or need_gl:
            gl_c, lo, hi, _ = self._chunk(c)
            gl_d = self._put(gl_c, "gl")
        if es is None:
            es = _chunk_eslabs(
                gl_d, self._freq_dev(freq, c, lo, hi),
                self._cbs, hi - lo, chain_kernel=self._ck,
            )
            if c < self._pin_k:
                self._eslab_cache[c] = es
        d_pre = self._dslab_dev(c) if self._cache_d else None
        return (gl_d if need_gl else None, None, self._dist_dev(c),
                (*es, d_pre), lo, hi)

    def _dslab_dev(self, c):
        """Run-lifetime device cache of chunk c's laid-out dist slab."""
        out = self._dslab_cache.get(c)
        if out is None:
            out = _chunk_dslab(self._dist_dev(c), self._cbs, self.N,
                               chain_kernel=self._ck)
            self._dslab_cache[c] = out
        return out

    def _dcomp_dev(self, c):
        """Run-lifetime device cache of chunk c's v2 dist compact."""
        out = self._dcomp_cache.get(c)
        if out is None:
            bs2, nb_p = self._cbs
            out = _chunk_dcomp(self._dist_dev(c), bs2, nb_p)
            self._dcomp_cache[c] = out
        return out

    def _freq_pad_dev(self, freq):
        """Host [S] freq -> padded [C*cs] f32 device vector."""
        f = np.asarray(freq, np.float32)
        pad = self.C * self.cs - self.S
        if pad:
            f = np.pad(f, (0, pad), constant_values=0.25)
        return jnp.asarray(f)

    def _pull_chunk_outs(self, outs):
        """[C] lists of per-chunk device outputs -> [C, ...] host arrays.

        Single-process: the per-chunk outputs are queued device-side and
        pulled through ONE stacked transfer -- a d2h copy per array is a
        host sync each, C chunks x 6 arrays per gradient stream. Multi-process keeps the per-array
        local_slab path (outputs are global arrays)."""
        if self.multi:
            return tuple(
                np.stack([self._loc(x, 0) for x in col])
                for col in zip(*outs)
            )
        cols = tuple(
            _stack_dev(*col) for col in zip(*outs)
        )  # [n_out] device [C, ...] stacks
        flat = np.asarray(_flat_concat(*cols))  # ONE d2h transfer
        res = []
        off = 0
        for col in cols:
            n = int(np.prod(col.shape))
            res.append(flat[off:off + n].reshape(col.shape))
            off += n
        return tuple(res)

    def _transfers_grad(self, freq, F, alpha, keep_areps=False):
        """ONE stream -> per-chunk transfers + parameter tangents
        (the fused objective+gradient pass of the streamed L-BFGS).

        keep_areps (fused tier): additionally return {chunk: A_r}
        device-resident per-block transfer rows for pass B's posterior
        reuse (~1.5 MB per 1M x 100 chunk) -- only pass A sets it; the
        M-step's line-search evaluations at other params do not."""
        F_d = self._put(F, "ind", jnp.float32)
        a_d = self._put(alpha, "ind", jnp.float32)
        keep = keep_areps and self._ck == "fused"
        areps = {} if keep else None
        outs = []
        for c in range(self.C):
            gl_d, fq_d, d_d, pre, lo, hi = self._chunk_inputs(freq, c)
            res = _chunk_transfer_grad(
                gl_d, fq_d, d_d, F_d, a_d, self._cbs,
                self.cs if pre is not None else hi - lo,
                chain_kernel=self._ck, pre=pre,
                cs=self.cs if pre is not None else None,
                N=self.N if pre is not None else None,
                return_areps=keep,
            )
            if keep:
                areps[c] = res[-1]
                res = res[:-1]
            outs.append(res)
        host = self._pull_chunk_outs(outs)
        return (host, areps) if keep_areps else host

    def _transfers(self, freq, F, alpha):
        F_d = self._put(F, "ind", jnp.float32)
        a_d = self._put(alpha, "ind", jnp.float32)
        outs = []
        for c in range(self.C):
            gl_d, fq_d, d_d, pre, lo, hi = self._chunk_inputs(freq, c)
            outs.append(_chunk_transfer(
                gl_d, fq_d, d_d, F_d, a_d, self._cbs,
                self.cs if pre is not None else hi - lo,
                chain_kernel=self._ck, pre=pre,
                cs=self.cs if pre is not None else None,
                N=self.N if pre is not None else None,
            ))
        return self._pull_chunk_outs(outs)

    def posteriors_pass(self, freq, F, alpha, p_ibd_out):
        """ONE posterior-only pass at the given params (no M-steps):
        fills p_ibd_out [S, N_loc] with exactly the IBD posteriors an
        EM iteration at these params would produce. Used once after
        convergence -- writing p_ibd every iteration would push the
        full [S, N] matrix to its (possibly disk-backed) buffer tens of
        times for values only the final iteration of which are read."""
        Ts, ss = self._transfers(freq, F, alpha)
        v0, wT, _, _ = _assemble_chain(Ts, ss, F)
        F_d = self._put(F, "ind", jnp.float32)
        a_d = self._put(alpha, "ind", jnp.float32)
        for c in range(self.C):
            gl_d, fq_d, d_d, pre, lo, hi = self._chunk_inputs(freq, c)
            p_c, _ = _chunk_estep(
                gl_d, fq_d, d_d, F_d, a_d,
                self._put(v0[c], "ind2", jnp.float32),
                self._put(wT[c], "ind2", jnp.float32),
                self._cbs, self.cs,
                self.cs if pre is not None else hi - lo,
                with_freq=False, chain_kernel=self._ck, pre=pre,
                cs=self.cs if pre is not None else None,
                N=self.N if pre is not None else None,
            )
            p_ibd_out[lo:hi] = self._loc(p_c, 1)[: hi - lo]

    def _stream_iteration(self, freq, F, alpha, opts):
        """One streamed EM iteration: chain pass, posterior/freq pass,
        and the host-L-BFGS (F, alpha) M-step.  Returns
        (freq', F', alpha', ll_f, fwbw_maxdiff)."""
        self._config_kernel(opts)
        N = self.N
        # ---- pass A: chain at current params. When the (F, alpha)
        # M-step will run, pass A IS its first evaluation: the M-step's
        # x0 = clip(F, alpha) with the PRE-update freq is exactly these
        # params, so one fused transfer+tangent stream serves both (the
        # fused kernel's primal chain shares the primal's op order and
        # rescale, so Ts/ss are the same values) -- one fewer full pass
        # over every chunk per EM iteration (round-4 VERDICT ask #2).
        mstep = not (opts.indF_fixed and opts.alpha_fixed)
        grads_A = None
        areps_A = None  # pass A's device-resident per-block transfer
        #                 rows, reused by pass B's posteriors (fused
        #                 tier; same params, bit-identical values)
        if mstep:
            (Ts, ss, dTF, dsF, dTa, dsa), areps_A = self._transfers_grad(
                freq, F, alpha, keep_areps=True)
            grads_A = (dTF, dsF, dTa, dsa)
        else:
            Ts, ss = self._transfers(freq, F, alpha)
        v0, wT, ll_f, ll_b = _assemble_chain(Ts, ss, F)
        # fw/bw check over ALL individuals (gathered when multi-process)
        fwbw = float(self._gather_ind(np.abs(ll_f - ll_b)).max())

        # ---- pass B: posteriors + chunk-local freq M-step. Skipped
        # whole when freq is fixed: its only live outputs are the
        # est_maf freq updates (posteriors are recomputed by the final
        # posteriors_pass; here they existed only to feed est_maf)
        F_d = self._put(F, "ind", jnp.float32)
        a_d = self._put(alpha, "ind", jnp.float32)
        # single-process: ONE h2d for all chunk carries, sliced on
        # device per chunk (eager ops on multi-process global arrays are
        # not addressable -- those keep the per-chunk puts)
        if not self.multi and opts.freq_est == 1:
            v0_d = jnp.asarray(np.ascontiguousarray(v0), jnp.float32)
            wT_d = jnp.asarray(np.ascontiguousarray(wT), jnp.float32)
            if self.mesh is not None:
                v0_d = jax.device_put(v0_d, self._sh["gl"])
                wT_d = jax.device_put(wT_d, self._sh["gl"])
        new_freq = freq if self.device_freq else freq.copy()
        f_parts = []
        for c in range(self.C if opts.freq_est == 1 else 0):
            gl_d, fq_d, d_d, pre, lo, hi = self._chunk_inputs(
                freq, c, need_gl=True  # est_maf reads the raw GLs
            )
            if self.multi:
                v0_c = self._put(v0[c], "ind2", jnp.float32)
                wT_c = self._put(wT[c], "ind2", jnp.float32)
            else:
                v0_c, wT_c = v0_d[c], wT_d[c]
            p_c, f_c = _chunk_estep(
                gl_d, fq_d, d_d, F_d, a_d,
                v0_c, wT_c,
                self._cbs, self.cs,
                self.cs if pre is not None else hi - lo,
                chain_kernel=self._ck, pre=pre,
                cs=self.cs if pre is not None else None,
                N=self.N if pre is not None else None,
                areps=None if areps_A is None else areps_A.get(c),
            )
            if opts.freq_est == 1:
                if self.device_freq:
                    # stays on device: the [cs]-chunk outputs reassemble
                    # the padded [C*cs] vector with zero host traffic
                    f_parts.append(f_c)
                else:
                    new_freq[lo:hi] = self._rep(f_c)[: hi - lo]
        if self.device_freq and opts.freq_est == 1:
            new_freq = _concat_dev(*f_parts)

        # ---- M-step (F, alpha): host L-BFGS over streamed evals,
        # emissions from the PRE-update freq (iter_EM order,
        # EM.cpp:189-271)
        if mstep:
            lo_b = np.stack(
                [np.full(N, F_MIN), np.full(N, ALPHA_MIN)], -1)
            hi_b = np.stack(
                [np.full(N, F_MAX), np.full(N, ALPHA_MAX)], -1)
            if opts.indF_fixed:
                lo_b[:, 0] = hi_b[:, 0] = F
            if opts.alpha_fixed:
                lo_b[:, 1] = hi_b[:, 1] = alpha

            def vag(x):
                # fused: ONE stream yields transfers + tangents;
                # carries and the gradient assemble on host
                Tx, sx, dTF, dsF, dTa, dsa = self._transfers_grad(
                    freq, x[:, 0], x[:, 1]
                )
                v0x, wTx, llx, _ = _assemble_chain(Tx, sx, x[:, 0])
                gF, ga = _grad_from_transfers(
                    Tx, dTF, dsF, dTa, dsa, v0x, wTx
                )
                return -llx, -np.stack([gF, ga], -1)

            x_base = np.stack([F, alpha], -1)
            x0 = np.clip(x_base, lo_b, hi_b)
            # pass A evaluated the chain at exactly (F, alpha) with
            # this freq; when the clip is a no-op, its transfers +
            # tangents ARE the first evaluation -- assemble the
            # gradient from them and seed the optimizer
            f0g0 = None
            if grads_A is not None and np.array_equal(x0, x_base):
                gF0, ga0 = _grad_from_transfers(Ts, *grads_A, v0, wT)
                f0g0 = (-ll_f, -np.stack([gF0, ga0], -1))
            # every line-search probe is one value-and-grad stream
            # (speculative full step + interpolated backtracking); the
            # curvature memory carries across EM iterations so the warm
            # M-step is typically 1-3 streams instead of a cold ~10+
            # noise_eps: the objective runs in f32 device kernels even
            # though the host vectors are float64 -- the line-search
            # noise floor must match the objective's resolution
            x_opt, _, _, self._opt_mem = lbfgsb_minimize_host(
                None, x0, lo_b, hi_b, value_and_grad=vag,
                warm=self._opt_mem, return_memory=True,
                noise_eps=float(np.finfo(np.float32).eps),
                f0g0=f0g0,
            )
            F, alpha = x_opt[:, 0], x_opt[:, 1]

        return new_freq, F, alpha, ll_f, fwbw

    def run(self, freq0, indF0, alpha0, opts: EMOptions, p_ibd_out=None,
            checkpoint_cb=None, resume_bookkeeping=None, trace=None):
        """Host EM loop. Returns (freq, indF, alpha, ind_lkl, n_iters).

        p_ibd_out: optional host array [S, N] filled with the final
        iteration's IBD posteriors. checkpoint_cb(n_iter, (freq, F,
        alpha), bookkeeping): called after every iteration (the tiny
        parameter state is all an exact resume needs -- emissions are a
        function of freq); resume_bookkeeping: such a dict to continue
        from (pass the checkpointed freq/F/alpha as freq0/indF0/alpha0).
        The convergence gate/bookkeeping live in
        models/driver.convergence_loop (one loop for every mode).
        """
        from .driver import convergence_loop

        if opts.freq_est not in (0, 1) or opts.e_prob_calc != 1:
            raise NotImplementedError(
                "streaming EM supports freq_est 0/1 with e_prob_calc 1 "
                "only (the LD path and the site-1-only emission quirk "
                "need the monolithic engine)"
            )

        self._config_kernel(opts)

        state0 = (
            self._freq_pad_dev(freq0) if self.device_freq
            else np.asarray(freq0, np.float64).copy(),
            np.asarray(indF0, np.float64).copy(),
            np.asarray(alpha0, np.float64).copy(),
            np.full(self.N, -np.inf),  # ll_f of the last iteration
        )

        def _freq_host(f):
            """Device-padded (or host) freq -> host [S] float64."""
            return np.asarray(f, np.float64)[: self.S]

        self._opt_mem = None
        if resume_bookkeeping and "opt_mem" in resume_bookkeeping:
            resume_bookkeeping = dict(resume_bookkeeping)
            raw = resume_bookkeeping.pop("opt_mem")
            if not self.multi and np.asarray(raw[0]).shape[1] == self.N:
                self._opt_mem = tuple(
                    np.asarray(x, d) for x, d in zip(
                        raw, (np.float64, np.float64, bool, np.int32)
                    )
                )

        # params entering the LAST iteration: the reference writes the
        # marg_prob computed by the final iter_EM call from its
        # PRE-update parameters (EM.cpp:178-185 before :189-271), so the
        # post-loop posterior pass must use these, not the final params
        prev_params = [state0[:3]]

        def step(st, active):
            freq, F, alpha, _ = st
            prev_params[0] = (freq, F, alpha)
            freq, F, alpha, ll_f, fwbw = self._stream_iteration(
                freq, F, alpha, opts
            )
            # the gate sees the GLOBAL per-ind lkls (allgathered when
            # multi-process, so every host's loop decides identically)
            return (freq, F, alpha, ll_f), self._gather_ind(ll_f), \
                np.asarray([fwbw])

        def ckpt(n_iter, st, bk):
            if checkpoint_cb is not None:
                bk = dict(bk)
                bk.pop("history", None)  # stream schema stores no history
                # single-process: the warm M-step memory rides the
                # checkpoint for an exact resume. Multi-process streams
                # skip it (each process holds only its local-ind block;
                # a resume then cold-starts the optimizer, changing only
                # PGTOL-bounded endpoints).
                if not self.multi and self._opt_mem is not None:
                    bk["opt_mem"] = self._opt_mem
                # gather the per-ind params on EVERY process (lockstep
                # collectives); the callback decides who writes
                checkpoint_cb(
                    n_iter,
                    (_freq_host(st[0]), self._gather_ind(st[1]),
                     self._gather_ind(st[2])),
                    bk,
                )

        tr = trace
        if trace is not None and self.multi:
            def tr(event, **kw):
                if event == "iter_done":
                    st = kw["state"]
                    # full per-ind views for verbose handlers (lockstep)
                    kw["state"] = (st[0], self._gather_ind(st[1]),
                                   self._gather_ind(st[2]), st[3])
                trace(event, **kw)

        state, bk, _ = convergence_loop(
            step,
            state0,
            opts,
            n_ind=self.N_tot,
            trace=tr,
            checkpoint_cb=ckpt if checkpoint_cb is not None else None,
            resume_bookkeeping=resume_bookkeeping,
        )
        freq, F, alpha, ll_f = state
        # params entering the last iteration, kept for callers that
        # defer the posterior pass (sequential restarts run it only for
        # the winning replicate)
        self._last_prev_params = prev_params[0]
        if bk.n_iter == 0 and resume_bookkeeping:
            # resumed run already converged: report the restored lkl
            # (global per-ind values; slice the local block back out)
            i0 = 0
            if self.multi:
                i0 = self._local_ind_offset()
            ll_f = np.asarray(resume_bookkeeping["prev_ind"],
                              np.float64)[i0:i0 + self.N]
        if p_ibd_out is not None:
            self.posteriors_pass(*prev_params[0], p_ibd_out)
        return _freq_host(freq), F, alpha, ll_f, bk.n_iter

    def _local_ind_offset(self):
        """Global index of this process's first individual column."""
        from ..parallel.distributed import axis_slab

        lo, cnt = axis_slab(self._sh["ind"], (self.N_tot,), 0)
        if cnt != self.N:
            raise ValueError(
                f"local gl has {self.N} inds but the mesh assigns "
                f"[{lo}, {lo + cnt})"
            )
        return lo


# ---------------------------------------------------------------------------
# streamed Viterbi decode (same boundary-state algebra as
# parallel/site_sharded.make_site_sharded_viterbi, chunk-sequential)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("valid",))
def _chunk_elog(gl_c, freq_c, valid):
    """Log emissions for a chunk; pad sites (>= valid) get e_log = 0
    (exact identities in both semirings)."""
    gl_lin = jnp.exp(gl_c)
    e_lin = emission_probs_linear(gl_lin, freq_c[:, None]).astype(jnp.float32)
    pad = (jnp.arange(e_lin.shape[0]) >= valid)[:, None, None]
    return jnp.log(jnp.where(pad, 1.0, e_lin))


@partial(jax.jit, static_argnames=("valid", "compat"))
def _chunk_maxplus(gl_c, freq_c, dist_c, F, alpha, valid, compat):
    """Chunk's max-plus transfer matrix V [N, 2, 2]."""
    from ..parallel.site_sharded import _maxplus_transfer

    e_log = _chunk_elog(gl_c, freq_c, valid)
    return _maxplus_transfer(e_log, dist_c, F, alpha, compat)


@partial(jax.jit, static_argnames=("compat",))
def _chunk_viterbi(e_log, dist_c, F, alpha, init_logits, final_state, compat):
    from .hmm import viterbi

    path, _ = viterbi(e_log, dist_c, F, alpha, compat=compat,
                      init_logits=init_logits, final_state=final_state)
    return path


def _maxplus_chain(Vs, F):
    """Host max-plus prefix/suffix over [C] chunk transfers.

    Returns (entries [C, N, 2] entry score vectors, exits [C, N] int8
    globally-optimal state at each chunk's last site)."""
    C, N = Vs.shape[0], Vs.shape[1]
    Vs = Vs.astype(np.float64)
    f = np.stack([np.log(1.0 - F), np.log(F)], -1)  # [N, 2]
    entries = np.empty((C, N, 2))
    for c in range(C):
        entries[c] = f
        f = np.stack([
            np.maximum(f[:, 0] + Vs[c, :, 0, 0], f[:, 1] + Vs[c, :, 1, 0]),
            np.maximum(f[:, 0] + Vs[c, :, 0, 1], f[:, 1] + Vs[c, :, 1, 1]),
        ], -1)
    g = np.zeros((N, 2))
    exits = np.empty((C, N), np.int8)
    for c in range(C - 1, -1, -1):
        # exit score of chunk c in state l: max_k entries[c][k]+V[c][k,l]
        e0 = np.maximum(entries[c][:, 0] + Vs[c, :, 0, 0],
                        entries[c][:, 1] + Vs[c, :, 1, 0])
        e1 = np.maximum(entries[c][:, 0] + Vs[c, :, 0, 1],
                        entries[c][:, 1] + Vs[c, :, 1, 1])
        exits[c] = (e1 + g[:, 1] > e0 + g[:, 0]).astype(np.int8)
        g = np.stack([
            np.maximum(Vs[c, :, 0, 0] + g[:, 0], Vs[c, :, 0, 1] + g[:, 1]),
            np.maximum(Vs[c, :, 1, 0] + g[:, 0], Vs[c, :, 1, 1] + g[:, 1]),
        ], -1)
    return entries, exits


def streaming_viterbi(se: "StreamingEM", freq, F, alpha, compat=True,
                      path_out=None):
    """Streamed decode: exact global Viterbi path, chunk by chunk.

    Returns path_out ([S, N] int8; allocated if None)."""
    if path_out is None:
        path_out = np.empty((se.S, se.N), np.int8)
    F32 = se._put(F, "ind", jnp.float32)
    a32 = se._put(alpha, "ind", jnp.float32)
    Vs = np.empty((se.C, se.N, 2, 2), np.float32)
    for c in range(se.C):
        gl_c, lo, hi, d_c = se._chunk(c)
        V = _chunk_maxplus(
            se._put(gl_c, "gl"),
            se._freq_dev(freq, c, lo, hi),
            se._dist_dev(c, d_c), F32, a32, hi - lo, compat,
        )
        Vs[c] = se._loc(V, 0)
    entries, exits = _maxplus_chain(Vs, np.asarray(F, np.float64))
    for c in range(se.C):
        # emissions-only recompute (no second max-plus scan)
        gl_c, lo, hi, d_c = se._chunk(c)
        e_log = _chunk_elog(
            se._put(gl_c, "gl"),
            se._freq_dev(freq, c, lo, hi),
            hi - lo,
        )
        path_c = _chunk_viterbi(
            e_log, se._dist_dev(c, d_c), F32, a32,
            se._put(entries[c], "ind2", jnp.float32),
            se._put(exits[c], "ind"), compat,
        )
        path_out[lo:hi] = se._loc(path_c, 1)[: hi - lo]
    return path_out
