"""The EM engine: one jitted iteration + a host-side convergence loop.

Accelerator redesign of the reference training loop (reference:
EM.cpp:27-289):

 - the per-individual pthread fan-out (EM.cpp:151-159,198-201) becomes a
   batch axis inside single fused XLA programs;
 - the E-step is one forward-backward scan over all individuals;
 - the (F, alpha) M-step optimises ALL individuals simultaneously with a
   batched box-constrained L-BFGS driven by autodiff (vs per-individual
   serial L-BFGS-B with central differences, EM.cpp:423-439);
 - the serial per-site freq M-step (EM.cpp:224-271, the reference's scaling
   bottleneck) becomes one masked fixed point over every site at once;
 - convergence bookkeeping (EM.cpp:56,75-97) is replicated exactly on host.

State layout (site-major, 0-based):
  gl      [S, N, 3]  normalised log genotype likelihoods (read-only)
  dist    [S]        Mb distances; dist[0] = first-site coordinate quirk
  freq    [S]        minor allele frequencies
  indF    [N], alpha [N]
  e_prob  [S, N, 2]  log emissions
  p_ibd   [S, N]     IBD posterior (marg_prob[..][1]), check_interv-snapped
"""

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.emissions import calc_emission, emission_probs_linear
from ..ops.hwe import check_interv
from ..ops.maf import est_maf
from ..utils.constants import (
    ALPHA_MAX,
    ALPHA_MIN,
    F_MAX,
    F_MIN,
)
from .hmm import forward_loglik, loglik_value_and_grad, posteriors, viterbi
from .hmm_blocked import (
    block_sites,
    forward_loglik_blocked,
    forward_loglik_blocked_lin,
    loglik_value_and_grad_blocked,
    loglik_value_and_grad_blocked_lin,
    pick_block_size,
    posteriors_blocked,
    posteriors_blocked_lin,
)
from . import hmm_pallas
from .lbfgsb import lbfgsb_minimize


@dataclasses.dataclass(frozen=True)
class EMOptions:
    """Engine flags mirroring the reference CLI (parse_args.cpp:43-68)."""

    freq_est: int = 1
    e_prob_calc: int = 1
    indF_fixed: bool = False
    alpha_fixed: bool = False
    min_iters: int = 10
    max_iters: int = 100
    min_epsilon: float = 1e-5
    viterbi_compat: bool = True
    lkl_check_tol: float = 0.001  # EM.cpp:166-170
    check_fwbw: bool = True
    verbose: int = 1
    # Carry the (F, alpha) M-step's L-BFGS curvature memory across EM
    # iterations (the objective changes only through the damped e_prob
    # update, so the previous iteration's Hessian approximation is a
    # near-perfect preconditioner: the M-step typically finishes in 1-3
    # value-and-grad passes instead of a cold-started 10-40). The
    # reference cold-starts its L-BFGS-B every iteration (EM.cpp:438);
    # per-M-step ENDPOINTS still agree to the shared PGTOL so outputs
    # stay within the golden tolerance gates. Memory is included in
    # checkpoints, keeping resume exact.
    warm_mstep: bool = True
    # None = sequential scan kernels (f64 reference-compatible); "auto" or
    # an int = blocked depth-O(sqrt S) kernels (XLA speed path).
    block_size: object = None
    # "log" (reference-faithful), "linear" (scaled probability-space XLA
    # kernels, transcendental-free hot loops; requires block_size) or
    # "pallas" (the Triton GL-fused chain kernels, resolve_numerics).
    numerics: str = "log"
    # --log N cadence (EM.cpp:59-63). run_em needs it to rebuild
    # DEFERRED state fields (e_prob, p_ibd) only on iterations whose
    # dump actually fires, instead of every iteration.
    log_every: int = 0
    # Store the GL-fused kernels' gl slabs in bfloat16 (pallas mode
    # only): halves the slabs' device footprint and every chain pass's
    # dominant stream bytes. Only the gl INPUT is quantised (~2^-9
    # relative -- far below genotype-likelihood model error); all
    # kernel math stays f32. Off by default: the f32 tier's tight
    # pallas-vs-XLA gates (2e-5) become ~1e-3-level under bf16.
    gl_bf16: bool = False


class EMState(NamedTuple):
    freq: jnp.ndarray
    indF: jnp.ndarray
    alpha: jnp.ndarray
    e_prob: jnp.ndarray
    p_ibd: jnp.ndarray
    ind_lkl: jnp.ndarray


class IterStats(NamedTuple):
    fwbw_maxdiff: jnp.ndarray  # scalar
    opt_iters: jnp.ndarray  # scalar


def init_state(gl, freq0, indF0, alpha0, e_prob_calc=1) -> EMState:
    """Initial EM state with emissions from the initial freqs
    (parse_args.cpp:370-387).

    e_prob_calc == 2: sites >= 2 get LD-conditioned pair emissions
    (parse_args.cpp:373-386) via the CORRECTED pair EM seeded with the
    initial freqs (the reference's own init call NaNs,
    gen_func.cpp:1160). These matter beyond iteration 1: under the dead
    outer gate (EM.cpp:252) the in-loop path never recomputes them when
    freq_est is 0/1, so the init values stay frozen for the whole run.
    """
    S, N = gl.shape[0], gl.shape[1]
    e_prob = calc_emission(gl, freq0[:, None])  # [S, N, 2]
    if e_prob_calc == 2:
        from ..ops.haplo import calc_emission_ld, haplo_freq

        hap = haplo_freq(
            gl[:-1], gl[1:], freq0[:-1], freq0[1:], compat=False
        )  # [S-1, 4]
        e_rest = jnp.stack(
            [
                calc_emission_ld(
                    hap[:, None, :], gl[:-1], gl[1:], freq0[:-1, None], k
                )
                for k in (0, 1)
            ],
            axis=-1,
        )  # [S-1, N, 2]
        e_prob = jnp.concatenate([e_prob[:1], e_rest])
    return EMState(
        freq=freq0,
        indF=indF0,
        alpha=alpha0,
        e_prob=e_prob,
        p_ibd=jnp.zeros((S, N), gl.dtype),
        ind_lkl=jnp.full((N,), -jnp.inf, gl.dtype),
    )


def resolve_numerics(numerics, freq_est=1, e_prob_calc=1, replicates=False,
                     site_mesh=False, mesh_stream=False):
    """The chain tier a run gets, chosen here and nowhere else:
    (numerics, note for --verbose >= 1, or None).

    "pallas" runs the Triton GL-fused kernels (models/hmm_pallas.py),
    which compute emissions in-kernel from (gl, one freq per site) and
    run one chain per (block, individual) lane on one device. Routes
    outside that contract take the XLA blocked-linear tier instead: LD
    emissions (e_prob 2 / freq_est 2), restart replicates (one freq
    vector per replicate), site/grid meshes (the chain crosses
    devices) and mesh-sharded streams (GSPMD cannot partition a
    pallas_call over the ind axis)."""
    if numerics != "pallas":
        return numerics, None
    if e_prob_calc != 1 or freq_est == 2:
        why = "LD emissions"
    elif replicates:
        why = "restart replicates"
    elif site_mesh:
        why = "site-sharded meshes"
    elif mesh_stream:
        why = "mesh-sharded streams"
    else:
        return "pallas", "Triton GL-fused chain kernels"
    return "linear", f"{why} have no Triton route: XLA blocked-linear tier"


def in_loop_emission_form(freq_est, numerics, site_sharded=False):
    """Which recompute form ``state.e_prob`` carries AFTER an iteration:
    "linear" = ``jnp.log(ops.emissions.emission_probs_linear(...))``,
    "log" = ``ops.emissions.calc_emission``. Params-only checkpoint
    resumes (cli._rebuild_from_params) rebuild emissions with exactly
    this form, so it MUST track em_iteration's fast branch below
    (``fast = linear or use_fused``), resolve_numerics' pallas->linear
    rewrite, and site_sharded.site_em_iteration's
    always-linear recompute. freq_est 0 freezes the init form and
    freq_est 2 with e_prob_calc 1 recomputes via calc_emission (both
    "log")."""
    if freq_est == 1 and (site_sharded or numerics in ("linear", "pallas")):
        return "linear"
    return "log"


@partial(
    jax.jit,
    static_argnames=(
        "freq_est", "e_prob_calc", "indF_fixed", "alpha_fixed", "axis_name",
        "block_size", "numerics", "return_prep", "return_opt",
        "defer_emissions", "defer_posteriors", "gl_bf16",
    ),
)
def em_iteration(
    gl,
    dist,
    state: EMState,
    freq_est: int = 1,
    e_prob_calc: int = 1,
    indF_fixed: bool = False,
    alpha_fixed: bool = False,
    axis_name: Optional[str] = None,
    block_size: Optional[int] = None,
    numerics: str = "log",
    prep_slabs=None,
    return_prep: bool = False,
    opt_memory=None,
    return_opt: bool = False,
    defer_emissions: bool = False,
    defer_posteriors: bool = False,
    gl_bf16: bool = False,
):
    """One EM iteration (reference: iter_EM, EM.cpp:139-289).

    axis_name: set when running under shard_map with individuals sharded
    over a mesh axis; the freq M-step then psums its accumulators across
    it (the only collective in the step).

    block_size: use the depth-O(sqrt S) blocked HMM kernels
    (models/hmm_blocked.py) with this within-block length -- the XLA
    speed path (composed sequential scans are per-step-latency bound).
    "auto" picks the depth-minimising size; None keeps the sequential
    kernels whose float64 results are ULP-compatible with the reference.

    numerics: "log" (reference-faithful log-space semiring), "linear"
    (scaled probability-space XLA kernels; requires block_size), or
    "pallas" (the Triton GL-fused chain kernels, models/hmm_pallas.py;
    routes without a Triton form fall back to "linear" as
    resolve_numerics says). Both speed modes run transcendental-free
    hot loops and are ~equally accurate in f32 thanks to per-site
    renormalisation. State invariants are mode-independent: state.e_prob
    is ALWAYS log-space.

    prep_slabs / return_prep: (pallas mode) thread the run-constant gl
    slab layout across iterations instead of rebuilding it from gl
    every call. prep_slabs is the (g0, g2, dc) tuple a previous call
    returned; return_prep=True makes the return a 3-tuple (state, stats,
    next_slabs); next_slabs is None off the fused route.

    opt_memory / return_opt: thread the (F, alpha) M-step's L-BFGS
    curvature memory (lbfgsb.lbfgsb_minimize's (S, Y, valid, head)
    tuple) across EM iterations -- the warm start that makes the
    speculative t = 1 step land almost every outer iteration. Pass the
    tuple a previous call returned (None on the first iteration);
    return_opt=True appends the updated memory to the return tuple
    (after next_slabs when return_prep is also set).

    defer_emissions: fused-mode speed switch (run_em sets it): skip the
    per-iteration state.e_prob materialisation -- the fused kernels
    build emissions in-kernel from (gl, freq), so inside the loop e_prob
    is write-only; the returned state carries the STALE e_prob and the
    caller rebuilds it (log emission_probs_linear, the in-loop form)
    at loop exit and before checkpoints. Honoured only where that
    rebuild is exact: the fused route with freq_est 1.

    defer_posteriors: companion switch for state.p_ibd (run_em sets
    it): with freq_est == 0 nothing in the loop consumes the unpacked
    [S, N] posterior, so deferring it dead-codes the slab -> site-major
    unpack relayout + check_interv snap per iteration; the returned
    state carries the STALE p_ibd and run_em rebuilds it (one
    posteriors pass at the final iteration's PRE-update params) at loop
    exit and before checkpoint/--log dumps. Honoured only on the fused
    route with freq_est == 0.

    gl_bf16: store the gl slabs in bfloat16 (EMOptions.gl_bf16; fused
    route only -- halves slab bytes; kernels upcast at load). Only
    matters when THIS call builds the slabs (prep_slabs is None):
    threaded slabs keep their dtype.
    """
    N = gl.shape[1]
    S = gl.shape[0]
    dtype = gl.dtype
    if numerics not in ("log", "linear", "pallas"):
        raise ValueError(
            f"numerics must be 'log', 'linear' or 'pallas', got {numerics!r}"
        )
    if numerics == "linear" and not block_size:
        raise ValueError("numerics='linear' requires block_size")
    numerics, _ = resolve_numerics(numerics, freq_est, e_prob_calc)
    # the Triton GL-fused kernels: emissions computed in-kernel from
    # (gl, freq) (hmm_pallas "lanes" layout) -- exactly where the
    # in-loop emission form IS the standard (gl, freq) formula
    use_fused = numerics == "pallas"
    linear = numerics == "linear"
    if linear and not block_size:
        block_size = "auto"  # a pallas request resolved to linear
    if block_size == "auto":
        block_size = pick_block_size(S)

    # ---- E-step: forward-backward posteriors (EM.cpp:147-185)
    A_g0 = None  # fused transfer+tangent carries when the E-step
    #              doubles as the M-step's first evaluation (fused route)
    if use_fused:
        if prep_slabs is not None:
            bs2, nbp2 = hmm_pallas.pick_geom2(S, N)
            prep2 = hmm_pallas.make_prep2(*prep_slabs, S, N, bs2, nbp2)
        else:
            prep2 = hmm_pallas.prepare_gl_inputs(
                jnp.exp(gl), dist,
                gl_dtype=jnp.bfloat16 if gl_bf16 else jnp.float32,
            )
        fc = hmm_pallas.freq_compact(state.freq, prep2)
        # E-step / M-step merge (streaming's pass-A/f0 merge, here for
        # the monolithic loop): when the (F, alpha) M-step will run, the
        # transfer pass is upgraded to the fused transfer+TANGENT stream
        # -- its primal rows ARE the transfer products (bit-for-bit,
        # transfer_grad_reps_fused docstring), so the posteriors reuse
        # them via A_reps and the M-step's first value-and-grad comes
        # out of the same stream instead of a separate full pass.
        A_reps0 = None
        if not (indF_fixed and alpha_fixed):
            A_g0, A_reps0 = hmm_pallas.transfer_grad_reps_fused(
                state.indF, state.alpha, prep2, fc
            )
        p_raw, ll_f, ll_b = hmm_pallas.posteriors_fused(
            state.indF, state.alpha, prep2, fc, A_reps=A_reps0
        )
        p_raw = p_raw.astype(dtype)
        ll_f, ll_b = ll_f.astype(dtype), ll_b.astype(dtype)
    elif block_size:
        dist_blk, _ = block_sites(dist, block_size, 0.0)
        if linear:
            e_blk, _ = block_sites(jnp.exp(state.e_prob), block_size, 1.0)
            p_raw, ll_f, ll_b = posteriors_blocked_lin(
                e_blk, dist_blk, state.indF, state.alpha, S
            )
        else:
            e_blk, _ = block_sites(state.e_prob, block_size, 0.0)
            p_raw, ll_f, ll_b = posteriors_blocked(
                e_blk, dist_blk, state.indF, state.alpha, S
            )
    else:
        p_raw, ll_f, ll_b = posteriors(
            state.e_prob, dist, state.indF, state.alpha
        )
    # defer_posteriors (docstring): with freq_est 0 nothing in the loop
    # reads the UNPACKED posterior -- thread the stale state.p_ibd and
    # XLA dead-codes the slab -> [S, N] unpack relayout + snap
    defer_p_eff = defer_posteriors and use_fused and freq_est == 0
    p_ibd = state.p_ibd if defer_p_eff else check_interv(p_raw)
    ind_lkl = ll_f
    fwbw_maxdiff = jnp.max(jnp.abs(ll_f - ll_b))
    if axis_name is not None:
        fwbw_maxdiff = jax.lax.pmax(fwbw_maxdiff, axis_name)


    # ---- M-step 1: per-individual (F, alpha) (EM.cpp:189-206)
    opt_mem = opt_memory
    if indF_fixed and alpha_fixed:
        indF, alpha = state.indF, state.alpha
        opt_iters = jnp.asarray(0, jnp.int32)
    else:
        x0 = jnp.stack([state.indF, state.alpha], axis=-1)
        lo = jnp.stack(
            [
                state.indF if indF_fixed else jnp.full((N,), F_MIN, dtype),
                state.alpha if alpha_fixed
                else jnp.full((N,), ALPHA_MIN, dtype),
            ],
            axis=-1,
        )
        hi = jnp.stack(
            [
                state.indF if indF_fixed else jnp.full((N,), F_MAX, dtype),
                state.alpha if alpha_fixed
                else jnp.full((N,), ALPHA_MAX, dtype),
            ],
            axis=-1,
        )

        if use_fused:

            def objective(x):
                ll = hmm_pallas.forward_loglik_fused(
                    x[None, :, 0], x[None, :, 1], prep2, fc
                )[0]
                return -ll.astype(dtype)

            def objective_vag(x):
                L, gF, ga = hmm_pallas.loglik_value_and_grad_fused(
                    x[:, 0], x[:, 1], prep2, fc
                )
                return (-L.astype(dtype),
                        -jnp.stack([gF, ga], axis=-1).astype(dtype))

        elif block_size:
            _ll = forward_loglik_blocked_lin if linear else forward_loglik_blocked
            _vag = (
                loglik_value_and_grad_blocked_lin
                if linear
                else loglik_value_and_grad_blocked
            )

            def objective(x):
                return -_ll(x[:, 0], x[:, 1], e_blk, dist_blk)

            def objective_vag(x):
                L, gF, ga = _vag(x[:, 0], x[:, 1], e_blk, dist_blk)
                return -L, -jnp.stack([gF, ga], axis=-1)

        else:

            def objective(x):
                return -forward_loglik(x[:, 0], x[:, 1], state.e_prob, dist)

            def objective_vag(x):
                L, gF, ga = loglik_value_and_grad(
                    x[:, 0], x[:, 1], state.e_prob, dist
                )
                return -L, -jnp.stack([gF, ga], axis=-1)

        f0g0 = None
        if use_fused and A_g0 is not None:
            # the E-step's fused stream already evaluated the chain AND
            # its tangents at exactly these params: assemble the
            # optimizer's first (value, gradient) from its carries
            # (identical values to objective_vag(x0) -- same kernel,
            # same assembly) instead of re-streaming. Valid only when
            # the core's box clip is a no-op; out-of-box inits (library
            # callers) fall back to a real evaluation via a scalar cond.
            L0, gF0, ga0 = hmm_pallas.grad_from_carries_pallas(
                A_g0, state.indF
            )
            f0_pre = -L0.astype(dtype)
            g0_pre = -jnp.stack([gF0, ga0], axis=-1).astype(dtype)
            seed_ok = jnp.all((x0 >= lo) & (x0 <= hi))
            f0g0 = jax.lax.cond(
                seed_ok,
                lambda: (f0_pre, g0_pre),
                lambda: objective_vag(jnp.clip(x0, lo, hi)),
            )
        x_opt, _, opt_iters, opt_mem = lbfgsb_minimize(
            objective, x0, lo, hi, value_and_grad=objective_vag,
            warm=opt_memory, return_memory=True, f0g0=f0g0,
        )
        if axis_name is not None:
            # each ind-shard's batched L-BFGS converges at its own pace;
            # report the max so the replicated out-spec is truthful
            opt_iters = jax.lax.pmax(opt_iters, axis_name)
        indF, alpha = x_opt[:, 0], x_opt[:, 1]

    # ---- M-step 2: per-site freq + emission recompute (EM.cpp:210-272)
    if freq_est == 0:
        # Emissions frozen too: the recompute lives inside the freq-est
        # branch (SURVEY.md §3.6e).
        freq, e_prob = state.freq, state.e_prob
    elif freq_est == 1:
        fast = linear or use_fused
        if fast:
            # Transcendental-free fixed point + emissions; state.e_prob
            # stays log-space (one log pass at the end).
            gl_lin = jnp.exp(gl)
            # speed tiers emulate the damped fixed point by linearised
            # macro-stepping (ops/maf.py docstring): ~5x fewer full-width
            # passes, ~1e-5 trajectory deviation, and on meshes ~7x fewer
            # est_maf collectives per EM iteration
            freq = est_maf(
                gl_lin, p_ibd, axis_name=axis_name, linear=True, macro=True,
            )
        else:
            freq = est_maf(gl, p_ibd, axis_name=axis_name)
        if e_prob_calc == 1:
            if fast and defer_emissions and use_fused:
                e_prob = state.e_prob  # stale by contract (docstring)
            elif fast:
                e_prob = jnp.log(emission_probs_linear(gl_lin, freq[:, None]))
            else:
                e_prob = calc_emission(gl, freq[:, None])
        else:
            # e_prob_calc == 2: the reference's outer gate
            # (EM.cpp:252 `if(e_prob_calc == 1 || s == 1)`) only ever
            # recomputes site 1 -- with plain calc_emission.
            e0 = calc_emission(gl[0], freq[0])
            e_prob = state.e_prob.at[0].set(e0)
    else:
        # freq_est == 2: the LD haplotype path. The reference's own
        # implementation is non-functional (a discarded accumulator
        # update, gen_func.cpp:1160, leaves every haplotype frequency
        # NaN), so there is no golden behaviour to match; this is the
        # CORRECTED path: the intended two-site haplotype EM
        # (gen_func.cpp:1027-1119) vectorised over all adjacent pairs.
        # Documented deviation from the serial reference flow
        # (EM.cpp:224-271): priors/inits use the previous EM iteration's
        # freqs for every pair (Jacobi) instead of the just-updated
        # freq[s-1] (Gauss-Seidel).
        from ..ops.haplo import calc_emission_ld, haplo_freq
        from ..ops.hwe import calc_hwe, post_prob

        prior = calc_hwe(state.freq[:, None], p_ibd)  # [S, N, 3] log
        pp = post_prob(gl, prior)
        hap = haplo_freq(
            pp[:-1], pp[1:], state.freq[:-1], state.freq[1:], compat=False
        )  # [S-1, 4]
        freq0 = est_maf(gl[0:1], p_ibd[0:1])  # site 0: est_maf (EM.cpp:243)
        freq = jnp.concatenate([freq0, hap[:, 1] + hap[:, 3]])
        e0 = calc_emission(gl[0:1], freq[0:1, None])
        if e_prob_calc == 2:
            e_rest = jnp.stack(
                [
                    calc_emission_ld(
                        hap[:, None, :], gl[:-1], gl[1:], freq[:-1, None], k
                    )
                    for k in (0, 1)
                ],
                axis=-1,
            )  # [S-1, N, 2]
            e_prob = jnp.concatenate([e0, e_rest])
        else:
            e_prob = jnp.concatenate(
                [e0, calc_emission(gl[1:], freq[1:, None])]
            )

    new_state = EMState(freq, indF, alpha, e_prob, p_ibd, ind_lkl)
    stats = IterStats(fwbw_maxdiff, opt_iters)
    out = (new_state, stats)
    if return_prep:
        # the gl slabs + dist compact are constants of the run: thread
        # them untouched (freq re-enters per call as fc)
        next_slabs = (
            (prep2["g0"], prep2["g2"], prep2["dc"]) if use_fused else None
        )
        out = out + (next_slabs,)
    if return_opt:
        out = out + (opt_mem,)
    return out


from .driver import array_max_pos as _array_max_pos  # noqa: E402 (back-compat)


@partial(jax.jit, static_argnames=("bf16",))
def _gl_slabs(gl, dist, bf16=False):
    """The run-constant (g0, g2, dc) slabs em_iteration threads."""
    p = hmm_pallas.prepare_gl_inputs(
        jnp.exp(gl), dist, gl_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    return p["g0"], p["g2"], p["dc"]


def restore_opt_memory(raw, n_cols, dtype, m=None):
    """Checkpointed L-BFGS memory -> device tuple, or None if it does not
    fit this run (different n_ind/n_rep/m or a pre-memory checkpoint --
    the resume then cold-starts the optimizer exactly like iteration 1).

    raw: the "opt_mem" bookkeeping entry ((S, Y, valid, head) as host
    arrays) or None; n_cols: this run's batch width (N or R*N)."""
    from .lbfgsb import MVAL

    if m is None:
        m = MVAL
    if raw is None:
        return None
    try:
        S, Y, valid, head = raw
    except (TypeError, ValueError):
        return None
    S = np.asarray(S)
    if S.shape != (m, n_cols, 2):
        return None
    head = np.asarray(head, np.int32)
    if head.ndim == 0:  # legacy scalar head -> per-row broadcast
        head = np.full((n_cols,), head, np.int32)
    return (
        jnp.asarray(S, dtype),
        jnp.asarray(Y, dtype),
        jnp.asarray(valid, bool),
        jnp.asarray(head, jnp.int32),
    )


@dataclasses.dataclass
class EMResult:
    state: EMState
    path: np.ndarray  # [S, N] int8 Viterbi path
    tot_lkl: float
    n_iters: int
    converged: bool
    lkl_history: list


def run_em(
    gl,
    dist,
    state: EMState,
    opts: EMOptions,
    log_callback=None,
    trace=None,
    checkpoint_cb=None,
    resume_bookkeeping=None,
) -> EMResult:
    """Full training loop (reference: EM, EM.cpp:27-135).

    log_callback(iter, state, tot_lkl): invoked at the top of every
    iteration like the --log N output rewrites (EM.cpp:59-63) -- the caller
    decides cadence (the reference fires on iter==1 or iter%log==0,
    including iter 0's pre-EM state).
    trace(event, **kw): optional stdout-parity hook; events "iter_start"
    and "iter_done" carry the values the reference prints at verbose 1-3.
    checkpoint_cb(n_iter, state, bookkeeping): invoked after every
    iteration with the host-loop bookkeeping dict needed for an exact
    resume; resume_bookkeeping: such a dict (io/checkpoint.py) to
    continue a run from where it stopped.
    """
    from .driver import convergence_loop

    N = gl.shape[1]
    fused = resolve_numerics(
        opts.numerics, opts.freq_est, opts.e_prob_calc)[0] == "pallas"
    # fused route: the run-constant gl slab layout is built once and
    # threaded across iterations, so every em_iteration call has the
    # same argument structure (one compile, not one per structure)
    prep_holder = {"slabs": None}
    if fused:
        prep_holder["slabs"] = _gl_slabs(gl, dist, bf16=opts.gl_bf16)

    # the warm-started M-step's curvature memory, threaded across
    # iterations and through checkpoints (bookkeeping key "opt_mem") so
    # a resumed run reproduces the uninterrupted trajectory exactly
    warm = opts.warm_mstep and not (opts.indF_fixed and opts.alpha_fixed)
    opt_holder = {"mem": None}
    if warm and resume_bookkeeping:
        resume_bookkeeping = dict(resume_bookkeeping)
        opt_holder["mem"] = restore_opt_memory(
            resume_bookkeeping.pop("opt_mem", None), state.indF.shape[0],
            gl.dtype,
        )
    if warm and opt_holder["mem"] is None:
        # a zeros memory IS the cold start; threading it from the first
        # call keeps the iteration at one compile
        from ..parallel.sharded_em import zero_opt_memory

        opt_holder["mem"] = zero_opt_memory(state.indF.shape[0], gl.dtype)

    # fused-mode loops never read state.e_prob: defer its per-iteration
    # materialisation and rebuild it (the exact in-loop "linear" form)
    # at loop exit and before checkpoints
    # (verbose >= 7's per-iteration emission dump reads state.e_prob
    # from the trace hook -- keep the live materialisation there)
    defer = fused and opts.freq_est == 1 and opts.verbose < 7
    # companion defer for state.p_ibd (em_iteration docstring): with
    # freq_est 0 the [S, N] unpack relayout + snap is write-only in-loop;
    # rebuild needs the final iteration's PRE-update params (the E-step
    # runs on the entering state), tracked per step below
    defer_p = fused and opts.freq_est == 0 and opts.verbose < 7
    prev_params = {"v": None}

    def _rebuild_eprob(st):
        e = jnp.log(
            emission_probs_linear(jnp.exp(gl), st.freq[:, None])
        ).astype(gl.dtype)
        return st._replace(e_prob=e)

    def _rebuild_pibd(st):
        """One posteriors pass at the final iteration's PRE-update
        params (check_interv-snapped) -- exactly the p_ibd the
        undeferred loop would carry."""
        if prev_params["v"] is None:
            return st
        freq_p, F_p, a_p = prev_params["v"]
        bs2, nbp2 = hmm_pallas.pick_geom2(gl.shape[0], N)
        prep2 = hmm_pallas.make_prep2(
            *prep_holder["slabs"], gl.shape[0], N, bs2, nbp2)
        fc = hmm_pallas.freq_compact(freq_p, prep2)
        # the rebuilt p_ibd matches the undeferred loop's to 1-2 f32
        # ulps (XLA forms FMAs differently in the standalone program
        # than inside the fused iteration; the kernels themselves are
        # deterministic)
        p, _, _ = hmm_pallas.posteriors_fused(F_p, a_p, prep2, fc)
        return st._replace(p_ibd=check_interv(p).astype(gl.dtype))

    def step(st, active):
        if defer_p:
            prev_params["v"] = (st.freq, st.indF, st.alpha)
        kw = dict(
            freq_est=opts.freq_est,
            e_prob_calc=opts.e_prob_calc,
            indF_fixed=opts.indF_fixed,
            alpha_fixed=opts.alpha_fixed,
            block_size=opts.block_size,
            numerics=opts.numerics,
            opt_memory=opt_holder["mem"] if warm else None,
            return_opt=warm,
            defer_emissions=defer,
            defer_posteriors=defer_p,
            gl_bf16=opts.gl_bf16,
        )
        if fused:
            out = em_iteration(
                gl, dist, st, prep_slabs=prep_holder["slabs"],
                return_prep=True, **kw
            )
            st2, stats, prep_holder["slabs"] = out[0], out[1], out[2]
        else:
            out = em_iteration(gl, dist, st, **kw)
            st2, stats = out[0], out[1]
        if warm:
            opt_holder["mem"] = out[-1]
        return st2, np.asarray(st2.ind_lkl), np.asarray(stats.fwbw_maxdiff)

    cb = checkpoint_cb
    if checkpoint_cb is not None and (warm or defer or defer_p):

        def cb(n_iter, st, bkd):
            if defer:
                st = _rebuild_eprob(st)  # checkpoints carry live e_prob
            if defer_p:
                st = _rebuild_pibd(st)
            if warm and opt_holder["mem"] is not None:
                bkd = dict(bkd)
                bkd["opt_mem"] = tuple(
                    np.asarray(x) for x in opt_holder["mem"]
                )
            checkpoint_cb(n_iter, st, bkd)

    log_cb = log_callback
    if log_callback is not None and defer_p and opts.log_every:

        def log_cb(n_iter, st, tot_):
            # the --log dump writes p_ibd (EM.cpp:59-63 -> .ibd rows):
            # rebuild the deferred posterior only on iterations whose
            # dump actually fires (the CLI's cadence check)
            if n_iter == 1 or n_iter % opts.log_every == 0:
                st = _rebuild_pibd(st)
            log_callback(n_iter, st, tot_)

    state, bk, _ = convergence_loop(
        step,
        state,
        opts,
        n_ind=N,
        log_callback=log_cb,
        trace=trace,
        checkpoint_cb=cb,
        resume_bookkeeping=resume_bookkeeping,
        track_history=True,
    )
    tot = float(bk.tot[0])
    converged = bk.n_iter < opts.max_iters
    if defer and bk.n_iter > 0:
        state = _rebuild_eprob(state)
    if defer_p and bk.n_iter > 0:
        state = _rebuild_pibd(state)

    # ---- Final Viterbi decode (EM.cpp:110-116)
    path, _ = viterbi(
        state.e_prob, dist, state.indF, state.alpha, compat=opts.viterbi_compat
    )
    return EMResult(
        state=state,
        path=np.asarray(path),
        tot_lkl=tot,
        n_iters=bk.n_iter,
        converged=converged,
        lkl_history=bk.history,
    )
