"""Site-dimension sharding: the long-context axis across chips.

The reference processes sites strictly sequentially inside one thread
(shared/HMM.cpp:13,40,104); hmm_blocked.py parallelises the site axis
WITHIN a chip. This module shards it ACROSS chips (the context-parallel
analog, SURVEY.md S5.7): each device owns a contiguous slab of sites and
the only cross-chip state is each shard's 2x2 transfer product --
 - every shard runs the local blocked linear passes on its slab;
 - an all_gather of the P normalised [N, 2, 2] shard transfers (tiny:
   P x N x 4 floats, rides NVLink) lets every shard compute the global
   prefix/suffix boundary carries AND the exact global likelihood
   redundantly (so L-BFGS decisions stay lockstep without broadcasts);
 - the freq M-step is fully LOCAL (sites sharded, individuals whole) --
   the dual of the individual-sharded layout in sharded_em.py whose only
   collective is the est_maf psum;
 - the gradient is a psum of per-shard site sums, plus the initial-
   distribution dF term on shard 0 only.

The 1-D ("site",) mesh shards sites with individuals whole; the 2-D
("ind", "site") grid mesh (make_grid_sharded_em_step) composes this
with individual sharding -- the BASELINE 1000-ind x 10M-site layout:
est_maf psums over "ind", the chain gathers over "site", and each
ind-shard's (F, alpha) optimiser runs locally in lockstep.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.em import EMState, IterStats
from ..models.hmm_blocked import (
    _block_transfer_lin,
    block_sites,
    fold_transfer_lin,
    loglik_value_and_grad_blocked_lin,
    pick_block_size,
    posteriors_blocked_lin,
)
from ..models.lbfgsb import lbfgsb_minimize
from ..ops.emissions import emission_probs_linear
from ..ops.hwe import check_interv
from ..ops.maf import est_maf
from ..utils.constants import ALPHA_MAX, ALPHA_MIN, F_MAX, F_MIN


def make_site_mesh(n_shards=None, devices=None):
    if devices is None:
        devices = jax.devices()
    if n_shards is None:
        n_shards = len(devices)
    arr = np.asarray(devices[:n_shards])
    return Mesh(arr, axis_names=("site",))


def _gather_chain(T, s, F, axis_name):
    """All-gather shard transfers; return boundary carries + global lls.

    T [N, 2, 2] (max-normalised), s [N] log scale of this shard.
    Returns (v0 [N,2], wT [N,2], ll_f [N], ll_b [N]) where v0/wT are the
    normalised forward/backward carries at this shard's boundaries and
    the lls are the GLOBAL likelihoods (identical on every shard).
    """
    N = T.shape[0]
    Ts = jax.lax.all_gather(T, axis_name)  # [P, N, 2, 2]
    ss = jax.lax.all_gather(s, axis_name)  # [P, N]
    Pn = Ts.shape[0]
    me = jax.lax.axis_index(axis_name)
    q1 = F
    q0 = 1.0 - F

    def fwd(i, carry):
        v0_, v1_, off, mine0, mine1 = carry
        mine0 = jnp.where(i == me, v0_, mine0)
        mine1 = jnp.where(i == me, v1_, mine1)
        r0 = v0_ * Ts[i, :, 0, 0] + v1_ * Ts[i, :, 1, 0]
        r1 = v0_ * Ts[i, :, 0, 1] + v1_ * Ts[i, :, 1, 1]
        m = jnp.maximum(jnp.maximum(r0, r1), 1e-30)
        inv = 1.0 / m
        return (r0 * inv, r1 * inv, off + jnp.log(m) + ss[i], mine0, mine1)

    z = jnp.zeros((N,), T.dtype)
    v0_, v1_, off, m0, m1 = jax.lax.fori_loop(
        0, Pn, fwd, (q0, q1, z, q0, q1)
    )
    ll_f = jnp.log(v0_ + v1_) + off
    v0 = jnp.stack([m0, m1], -1)

    def bwd(t, carry):
        i = Pn - 1 - t
        w0_, w1_, off, mine0, mine1 = carry
        mine0 = jnp.where(i == me, w0_, mine0)
        mine1 = jnp.where(i == me, w1_, mine1)
        r0 = Ts[i, :, 0, 0] * w0_ + Ts[i, :, 0, 1] * w1_
        r1 = Ts[i, :, 1, 0] * w0_ + Ts[i, :, 1, 1] * w1_
        m = jnp.maximum(jnp.maximum(r0, r1), 1e-30)
        inv = 1.0 / m
        return (r0 * inv, r1 * inv, off + jnp.log(m) + ss[i], mine0, mine1)

    one = jnp.ones((N,), T.dtype)
    w0_, w1_, offb, n0, n1 = jax.lax.fori_loop(
        0, Pn, bwd, (one, one, z, one, one)
    )
    ll_b = jnp.log(q0 * w0_ + q1 * w1_) + offb
    wT = jnp.stack([n0, n1], -1)
    return v0, wT, ll_f, ll_b


def _chain(F, alpha, e_blk, d_blk, axis_name):
    """Local transfer fold + cross-shard boundary assembly.

    Returns (v0, wT, ll_f, ll_b, A_ln); A_ln is the local block-transfer
    pass, returned so callers never recompute it for the same params."""
    A, ln = _block_transfer_lin(e_blk, d_blk, F, alpha)
    T, s = fold_transfer_lin(A, ln)
    v0, wT, ll_f, ll_b = _gather_chain(T, s, F, axis_name)
    return v0, wT, ll_f, ll_b, (A, ln)


def site_em_iteration(
    gl,
    dist,
    state: EMState,
    freq_est: int = 1,
    e_prob_calc: int = 1,
    indF_fixed: bool = False,
    alpha_fixed: bool = False,
    axis_name: str = "site",
    block_size=None,
    ind_axis_name=None,
    work_dtype=jnp.float32,
    S_total=None,
    opt_memory=None,
    return_opt=False,
):
    """One EM iteration on a site-sharded slab (runs under shard_map).

    opt_memory/return_opt: thread the (F, alpha) M-step's L-BFGS
    curvature memory across EM iterations (models/em.py warm start).
    The memory is replicated across site-shards (the optimizer runs the
    GLOBAL chain objective in lockstep on every shard; psum'd f/g make
    its update identical everywhere) and ind-sharded on 2-D meshes.

    gl/dist/state.freq/e_prob/p_ibd hold THIS SHARD's sites; indF/alpha/
    ind_lkl are replicated across site-shards (and, on a 2-D mesh,
    sharded over ind_axis_name: the est_maf accumulators then psum over
    that axis exactly as in sharded_em.py).

    work_dtype: precision of the chain/gradient kernels (float32 is the
    speed default; None follows gl.dtype so f64 compat validation of
    sharded runs is possible).
    The chain and freq passes are the XLA blocked-linear tier
    (models.em.resolve_numerics: site meshes have no Triton route).
    S_total: logical number of sites when the global site axis was
    padded up to a multiple of the shard count. Pad sites (global index
    >= S_total, i.e. the tail of the LAST shard) must enter with
    e_prob = 0 (log 1) and dist = 0 -- then their chain transfer is an
    exact identity (d=0 collapses the transition to delta_kl,
    HMM.cpp:130-139, independent of F/alpha, so likelihood, gradients
    and posteriors are untouched) -- and this keeps them that way: the
    emission recompute and freq update are masked back to identity on
    the pad rows.
    """
    S_loc, N = gl.shape[0], gl.shape[1]
    dtype = gl.dtype
    if freq_est == 2 or e_prob_calc == 2:
        raise NotImplementedError(
            "the LD haplotype path (freq_est/e_prob_calc == 2) is not "
            "implemented for site-sharded runs (pair posteriors would "
            "cross shard boundaries); use the single-chip engine"
        )
    if freq_est == 1 and e_prob_calc != 1:
        raise NotImplementedError(
            "e_prob_calc != 1 (the reference's site-1-only emission "
            "recompute quirk, EM.cpp:252) is not implemented sharded; "
            "use the single-chip engine"
        )
    if block_size is None:
        block_size = pick_block_size(S_loc)
    first = jax.lax.axis_index(axis_name) == 0
    wdt = work_dtype if work_dtype is not None else dtype
    pad_mask = None
    if S_total is not None:
        start = jax.lax.axis_index(axis_name) * S_loc
        pad_mask = (start + jnp.arange(S_loc)) >= S_total

    e_lin = jnp.exp(state.e_prob).astype(wdt)
    F32 = state.indF.astype(wdt)
    a32 = state.alpha.astype(wdt)
    e_blk, _ = block_sites(e_lin, block_size, 1.0)
    d_blk, _ = block_sites(dist.astype(wdt), block_size, 0.0)

    # ---- E-step (A_ln reused: the block-transfer pass runs once)
    v0, wT, ll_f, ll_b, A_ln = _chain(F32, a32, e_blk, d_blk, axis_name)
    p_raw, _, _ = posteriors_blocked_lin(
        e_blk, d_blk, F32, a32, S_loc, v0=v0, wT=wT, A_ln=A_ln
    )
    p_ibd = check_interv(p_raw).astype(dtype)
    ind_lkl = ll_f.astype(dtype)
    fwbw_maxdiff = jnp.max(jnp.abs(ll_f - ll_b)).astype(dtype)
    if ind_axis_name is not None:
        # identical across site-shards by construction, but each
        # ind-shard sees only its individuals: pmax keeps the
        # replicated out-spec truthful on 2-D meshes
        fwbw_maxdiff = jax.lax.pmax(fwbw_maxdiff, ind_axis_name)

    # ---- M-step 1: (F, alpha), global objective assembled per eval
    opt_mem = opt_memory
    if indF_fixed and alpha_fixed:
        indF, alpha = state.indF, state.alpha
        opt_iters = jnp.asarray(0, jnp.int32)
    else:
        x0 = jnp.stack([state.indF, state.alpha], -1)
        lo = jnp.stack(
            [
                state.indF if indF_fixed else jnp.full((N,), F_MIN, dtype),
                state.alpha if alpha_fixed else jnp.full((N,), ALPHA_MIN, dtype),
            ],
            -1,
        )
        hi = jnp.stack(
            [
                state.indF if indF_fixed else jnp.full((N,), F_MAX, dtype),
                state.alpha if alpha_fixed else jnp.full((N,), ALPHA_MAX, dtype),
            ],
            -1,
        )

        def objective(x):
            _, _, llf, _, _ = _chain(
                x[:, 0].astype(wdt), x[:, 1].astype(wdt),
                e_blk, d_blk, axis_name,
            )
            return -llf.astype(dtype)

        def objective_vag(x):
            Fx = x[:, 0].astype(wdt)
            ax = x[:, 1].astype(wdt)
            v0x, wTx, llf, _, A_lnx = _chain(
                Fx, ax, e_blk, d_blk, axis_name
            )
            # the initial-distribution dF term belongs to the whole
            # chain's site 0: a traced 0/1 weight keeps it on shard 0
            # only (psum broadcasts it), and A_ln reuse means ONE
            # block-transfer pass per evaluation
            Lloc, gF, ga = loglik_value_and_grad_blocked_lin(
                Fx, ax, e_blk, d_blk, v0=v0x, wT=wTx,
                with_init_term=first.astype(wdt), A_ln=A_lnx,
            )
            del Lloc  # segment-local; global ll comes from the chain
            g = jnp.stack([gF, ga], -1)
            g = jax.lax.psum(g, axis_name)
            return -llf.astype(dtype), -g.astype(dtype)

        x_opt, _, opt_iters, opt_mem = lbfgsb_minimize(
            objective, x0, lo, hi, value_and_grad=objective_vag,
            warm=opt_memory, return_memory=True,
        )
        if ind_axis_name is not None:
            opt_iters = jax.lax.pmax(opt_iters, ind_axis_name)
        indF, alpha = x_opt[:, 0], x_opt[:, 1]

    # ---- M-step 2: freq, fully local in sites
    if freq_est == 0:
        freq, e_prob = state.freq, state.e_prob
    else:
        gl_lin = jnp.exp(gl)
        # macro-stepping only on the f32 speed tier: the f64 compat
        # tier (numerics "log") must keep exact damped trajectories for
        # oracle validation
        freq = est_maf(
            gl_lin, p_ibd, linear=True, axis_name=ind_axis_name,
            macro=(wdt == jnp.float32),
        ).astype(dtype)
        e_prob = jnp.log(emission_probs_linear(gl_lin, freq[:, None]))
        if pad_mask is not None:
            # pad rows stay exact identities (e = 1); their est_maf
            # output is garbage-from-uniform-GLs and is discarded
            freq = jnp.where(pad_mask, state.freq, freq)
            e_prob = jnp.where(pad_mask[:, None, None], 0.0, e_prob)
    if pad_mask is not None:
        p_ibd = jnp.where(pad_mask[:, None], 0.0, p_ibd)

    new_state = EMState(freq, indF, alpha, e_prob, p_ibd, ind_lkl)
    stats = IterStats(fwbw_maxdiff, opt_iters)
    if return_opt:
        return new_state, stats, opt_mem
    return new_state, stats


def _site_opt_memory_specs(ind_axis):
    """Warm-start memory specs on site/grid meshes: replicated across
    "site" (lockstep global-chain optimizer), ind-sharded on grids --
    including the per-row head (sharded_em.opt_memory_specs)."""
    return (
        P(None, ind_axis, None),
        P(None, ind_axis, None),
        P(None, ind_axis),
        P(ind_axis),
    )


def make_site_sharded_em_step(mesh, freq_est=1, e_prob_calc=1,
                              indF_fixed=False, alpha_fixed=False,
                              work_dtype=jnp.float32, S_total=None,
                              warm=False):
    """Jitted shard_map'd EM step over a ("site",) mesh.

    gl [S, N, 3] and dist [S] sharded along sites; EMState: freq/e_prob/
    p_ibd sharded along sites, indF/alpha/ind_lkl replicated.
    work_dtype/S_total: see site_em_iteration.
    warm=True: the step threads the M-step's L-BFGS curvature memory,
    (gl, dist, state, mem) -> (state', stats, mem').
    """
    state_specs = EMState(
        freq=P("site"),
        indF=P(),
        alpha=P(),
        e_prob=P("site", None, None),
        p_ibd=P("site", None),
        ind_lkl=P(),
    )
    core = partial(
        site_em_iteration,
        freq_est=freq_est,
        e_prob_calc=e_prob_calc,
        indF_fixed=indF_fixed,
        alpha_fixed=alpha_fixed,
        axis_name="site",
        work_dtype=work_dtype,
        S_total=S_total,
        return_opt=warm,
    )
    in_specs = (P("site", None, None), P("site"), state_specs)
    out_specs = (state_specs, IterStats(P(), P()))
    if warm:
        mem_specs = _site_opt_memory_specs(None)
        body = lambda gl, dist, st, mem: core(gl, dist, st, opt_memory=mem)
        in_specs = in_specs + (mem_specs,)
        out_specs = out_specs + (mem_specs,)
    else:
        body = core
    step = shard_map(
        body,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(step)


def shard_site_inputs(mesh, gl, dist, state):
    dev = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    gl = dev(gl, P("site", None, None))
    dist = dev(dist, P("site"))
    specs = EMState(
        freq=P("site"), indF=P(), alpha=P(),
        e_prob=P("site", None, None), p_ibd=P("site", None), ind_lkl=P(),
    )
    state = EMState(*(dev(x, s) for x, s in zip(state, specs)))
    return gl, dist, state


# ---------------------------------------------------------------------------
# Site-sharded Viterbi decode
# ---------------------------------------------------------------------------


def _maxplus_transfer(e_prob, dist, F, alpha, compat):
    """Local max-plus transfer matrix V [N, 2, 2]: best within-shard path
    score entering in state k and leaving in state l.

    compat folds the reference's in-place update (SURVEY.md S3.6a) into
    the per-site max-plus matrix: M'[k,0] = lt_k0 + e0 and
    M'[k,1] = max(M'[k,0] + lt01, lt_k1-ish) + e1 -- derived from
    HMM.cpp:98-125's update order.
    """
    from ..models.hmm import _log_trans_elems

    N = F.shape[0]

    def step(V, xs):
        e_s, d_s = xs
        lt00, lt01, lt10, lt11 = _log_trans_elems(F, alpha, d_s)
        m00 = lt00 + e_s[:, 0]
        m10 = lt10 + e_s[:, 0]
        if compat:
            # state-1 goes through the updated state-0 score or directly
            m01 = m00 + lt01 + e_s[:, 1]
            m11 = jnp.maximum(m10 + lt01, lt11) + e_s[:, 1]
        else:
            m01 = lt01 + e_s[:, 1]
            m11 = lt11 + e_s[:, 1]
        n00 = jnp.maximum(V[:, 0, 0] + m00, V[:, 0, 1] + m10)
        n01 = jnp.maximum(V[:, 0, 0] + m01, V[:, 0, 1] + m11)
        n10 = jnp.maximum(V[:, 1, 0] + m00, V[:, 1, 1] + m10)
        n11 = jnp.maximum(V[:, 1, 0] + m01, V[:, 1, 1] + m11)
        return jnp.stack(
            [jnp.stack([n00, n01], -1), jnp.stack([n10, n11], -1)], -2
        ), None

    neg = jnp.full((N,), -jnp.inf, e_prob.dtype)
    zero = jnp.zeros((N,), e_prob.dtype)
    eye = jnp.stack(
        [jnp.stack([zero, neg], -1), jnp.stack([neg, zero], -1)], -2
    )
    V, _ = jax.lax.scan(step, eye, (e_prob, dist))
    return V


def _viterbi_shard(e_prob, dist, F, alpha, compat, axis_name):
    """Local Viterbi with globally-consistent boundary states."""
    from ..models.hmm import log_q, viterbi

    V = _maxplus_transfer(e_prob, dist, F, alpha, compat)
    Vs = jax.lax.all_gather(V, axis_name)  # [P, N, 2, 2]
    Pn = Vs.shape[0]
    me = jax.lax.axis_index(axis_name)
    N = F.shape[0]

    # forward max-plus prefix: f_p[k] = best score reaching shard p's
    # ENTRY in state k (f_0 = log q); suffix: g_p[k] = best completion
    # from shard p's entry state k (through shards p..P-1).
    def fwd(i, carry):
        f, mine = carry
        mine = jnp.where(i == me, f, mine)
        nf0 = jnp.maximum(f[:, 0] + Vs[i, :, 0, 0], f[:, 1] + Vs[i, :, 1, 0])
        nf1 = jnp.maximum(f[:, 0] + Vs[i, :, 0, 1], f[:, 1] + Vs[i, :, 1, 1])
        return jnp.stack([nf0, nf1], -1), mine

    lq = jnp.broadcast_to(log_q(F), (N, 2))
    _, f_mine = jax.lax.fori_loop(0, Pn, fwd, (lq, lq))

    def bwd(t, carry):
        i = Pn - 1 - t
        g, mine_next = carry
        # g currently = completion from shard (i+1)'s entry; record it as
        # OUR exit completion when i == me
        mine_next = jnp.where(i == me, g, mine_next)
        ng0 = jnp.maximum(Vs[i, :, 0, 0] + g[:, 0], Vs[i, :, 0, 1] + g[:, 1])
        ng1 = jnp.maximum(Vs[i, :, 1, 0] + g[:, 0], Vs[i, :, 1, 1] + g[:, 1])
        return jnp.stack([ng0, ng1], -1), mine_next

    zeros = jnp.zeros((N, 2), e_prob.dtype)
    _, g_exit = jax.lax.fori_loop(0, Pn, bwd, (zeros, zeros))

    # globally-optimal state at OUR right boundary (strict > tie rule to
    # match array_max_pos): score of exiting in state l =
    # max_k f_mine[k] + V[k, l]  +  g_exit[l]
    exit0 = jnp.maximum(f_mine[:, 0] + V[:, 0, 0], f_mine[:, 1] + V[:, 1, 0])
    exit1 = jnp.maximum(f_mine[:, 0] + V[:, 0, 1], f_mine[:, 1] + V[:, 1, 1])
    s_exit = (exit1 + g_exit[:, 1] > exit0 + g_exit[:, 0]).astype(jnp.int8)

    path, _ = viterbi(
        e_prob, dist, F, alpha, compat=compat,
        init_logits=f_mine, final_state=s_exit,
    )
    return path


def make_site_sharded_viterbi(mesh, compat=True):
    """Jitted sharded decode: (e_prob, dist, F, alpha) -> path [S, N]."""

    def body(e_prob, dist, F, alpha):
        return _viterbi_shard(e_prob, dist, F, alpha, compat, "site")

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P("site", None, None), P("site"), P(), P()),
        out_specs=P("site", None),
        check_vma=False,
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# Composed 2-D (ind, site) mesh: the BASELINE 1000-ind x 10M-site layout
# ---------------------------------------------------------------------------


def make_grid_mesh(n_ind_shards, n_site_shards, devices=None):
    if devices is None:
        devices = jax.devices()
    arr = np.asarray(devices[: n_ind_shards * n_site_shards]).reshape(
        n_ind_shards, n_site_shards
    )
    return Mesh(arr, axis_names=("ind", "site"))


def make_grid_sharded_em_step(mesh, freq_est=1, e_prob_calc=1,
                              indF_fixed=False, alpha_fixed=False,
                              work_dtype=jnp.float32, S_total=None,
                              warm=False):
    """EM step over a 2-D (ind, site) mesh.

    Layout: gl [S, N, 3] sharded P("site", "ind"); freq sharded over
    "site"; indF/alpha/ind_lkl sharded over "ind"; e_prob/p_ibd sharded
    over both. Collectives per step:
      - "site": all_gather of per-shard 2x2 transfer products (chain
        boundary assembly) + psum of (F, alpha) gradient site-sums;
      - "ind": psum of est_maf's expected-allele-count accumulators
        (the same single collective as the 1-D ind mesh).
    The (F, alpha) optimiser state is local to each ind-shard (its
    individuals), lockstep across site-shards.
    """
    state_specs = EMState(
        freq=P("site"),
        indF=P("ind"),
        alpha=P("ind"),
        e_prob=P("site", "ind", None),
        p_ibd=P("site", "ind"),
        ind_lkl=P("ind"),
    )

    def core(gl, dist, state, mem=None):
        return site_em_iteration(
            gl, dist, state,
            freq_est=freq_est, e_prob_calc=e_prob_calc,
            indF_fixed=indF_fixed, alpha_fixed=alpha_fixed,
            axis_name="site", ind_axis_name="ind",
            work_dtype=work_dtype, S_total=S_total,
            opt_memory=mem, return_opt=warm,
        )

    in_specs = (P("site", "ind", None), P("site"), state_specs)
    out_specs = (state_specs, IterStats(P(), P()))
    if warm:
        mem_specs = _site_opt_memory_specs("ind")
        body = core
        in_specs = in_specs + (mem_specs,)
        out_specs = out_specs + (mem_specs,)
    else:
        body = lambda gl, dist, st: core(gl, dist, st)
    step = shard_map(
        body,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(step)


def make_grid_sharded_viterbi(mesh, compat=True):
    """Decode over the 2-D (ind, site) grid mesh.

    Each ind-shard's chains are independent, so the 1-D site-sharded
    decode (_viterbi_shard: max-plus boundary exchange over "site") runs
    unchanged within every ind-shard; no "ind" collective at all."""

    def body(e_prob, dist, F, alpha):
        return _viterbi_shard(e_prob, dist, F, alpha, compat, "site")

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P("site", "ind", None), P("site"), P("ind"), P("ind")),
        out_specs=P("site", "ind"),
        check_vma=False,
    )
    return jax.jit(fn)


def shard_grid_inputs(mesh, gl, dist, state):
    dev = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    gl = dev(gl, P("site", "ind", None))
    dist = dev(dist, P("site"))
    specs = EMState(
        freq=P("site"), indF=P("ind"), alpha=P("ind"),
        e_prob=P("site", "ind", None), p_ibd=P("site", "ind"),
        ind_lkl=P("ind"),
    )
    state = EMState(*(dev(x, s) for x, s in zip(state, specs)))
    return gl, dist, state
