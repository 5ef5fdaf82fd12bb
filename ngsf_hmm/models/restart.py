"""Multi-restart protocol: the ngsF-HMM.sh replicate loop as a device axis.

The reference wrapper (reference: ngsF-HMM.sh:9,83-116) runs N_REP=20
independent full EM runs with re-rolled seeds and keeps the replicate
with the highest first-line log-likelihood of ``.indF``. Here the
replicates become a leading vmapped axis over ONE device program per
iteration: all restarts advance in lockstep, each with its own
convergence bookkeeping (a replicate that has converged is frozen while
the stragglers finish, exactly as independent runs would converge at
their own pace).

Seeding: the shell wrapper re-rolls ``--seed $RANDOM`` per replicate
(ngsF-HMM.sh:84), which is irreproducible by design; here replicate r
draws its random inits from GslTaus(seed + r) — deterministic and
documented. Replicate 0 reproduces a single run with ``--seed seed``.

On a multi-chip mesh the same protocol shards replicates over the
"restart" mesh axis instead (parallel/sharded_em.py).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..io.gsl_rng import GslTaus
from ..io.init import init_freq, init_indF_alpha
from .em import (
    EMOptions, EMResult, em_iteration, init_state, resolve_numerics,
)
from .hmm import viterbi


def stack_restart_states(gl, n_rep, seed, indF_spec="r", freq_spec="r",
                         alpha_literal=None, freq_est=1, e_prob_calc=1):
    """Build R independently-seeded initial EM states, stacked on axis 0.

    indF_spec/freq_spec follow the CLI's polymorphic init strings
    (parse_args.cpp:248-363): replicate r resolves any random draws with
    GslTaus(seed + r). freq_est/e_prob_calc select the LD init branches
    (parse_args.cpp:316-321,373-386) exactly as for a single run.
    Returns an EMState whose fields have a leading [R] axis.
    """
    S, N = gl.shape[0], gl.shape[1]
    states = []
    for r in range(n_rep):
        rng = GslTaus(seed + r)
        indF0, alpha0 = init_indF_alpha(indF_spec, N, rng)
        freq0 = init_freq(freq_spec, S, rng, gl=gl, freq_est=freq_est)
        if alpha_literal is not None:
            alpha0 = np.full(N, alpha_literal)
        states.append(
            init_state(
                gl,
                jnp.asarray(freq0, gl.dtype),
                jnp.asarray(indF0, gl.dtype),
                jnp.asarray(alpha0, gl.dtype),
                e_prob_calc=e_prob_calc,
            )
        )
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


@dataclasses.dataclass
class RestartResult:
    best: EMResult
    best_rep: int
    rep_lkl: np.ndarray  # [R] final total log-likelihoods
    rep_iters: np.ndarray  # [R] iterations each replicate ran


def run_em_restarts(gl, dist, states, opts: EMOptions, log_callback=None,
                    checkpoint_cb=None, resume_bookkeeping=None, trace=None):
    """Run R lockstep EM replicates; return the argmax-likelihood one.

    states: EMState with leading [R] axis (stack_restart_states).
    Selection matches ngsF-HMM.sh:97-99 (highest total log-likelihood).

    checkpoint_cb(n_iter, states, bookkeeping): invoked after every
    lockstep iteration with the stacked states and the host-loop arrays
    ([R]-shaped convergence bookkeeping) needed for an exact resume;
    resume_bookkeeping: such a dict to continue from.  The convergence
    gate, freeze semantics and checkpoint schema live in
    models/driver.convergence_loop (one loop for every mode).
    """
    from .driver import convergence_loop
    from .lbfgsb import MVAL

    R = states.indF.shape[0]
    N = gl.shape[1]

    numerics, _ = resolve_numerics(
        opts.numerics, opts.freq_est, opts.e_prob_calc, replicates=True)
    if numerics != opts.numerics:
        opts = dataclasses.replace(opts, numerics=numerics,
                                   block_size=opts.block_size or "auto")

    # warm-started M-step memory (models/em.py): [R, m, N, 2]. A zeros
    # memory IS the cold start (no valid pairs), so the step always
    # threads an explicit tuple (single trace).
    warm = opts.warm_mstep and not (opts.indF_fixed and opts.alpha_fixed)

    def _zero_mem():
        dt = gl.dtype
        return (
            jnp.zeros((R, MVAL, N, 2), dt),
            jnp.zeros((R, MVAL, N, 2), dt),
            jnp.zeros((R, MVAL, N), bool),
            jnp.zeros((R, N), jnp.int32),
        )

    opt_holder = {"mem": _zero_mem() if warm else None}
    if warm and resume_bookkeeping:
        resume_bookkeeping = dict(resume_bookkeeping)
        raw = resume_bookkeeping.pop("opt_mem", None)
        if raw is not None and np.asarray(raw[0]).shape == (R, MVAL, N, 2):
            opt_holder["mem"] = tuple(
                jnp.asarray(x, d) for x, d in zip(
                    raw, (gl.dtype, gl.dtype, bool, jnp.int32)
                )
            )

    def _one(st, mem):
        return em_iteration(
            gl,
            dist,
            st,
            freq_est=opts.freq_est,
            e_prob_calc=opts.e_prob_calc,
            indF_fixed=opts.indF_fixed,
            alpha_fixed=opts.alpha_fixed,
            block_size=opts.block_size,
            numerics=opts.numerics,
            opt_memory=mem,
            return_opt=True,
        )

    vstep = jax.jit(jax.vmap(_one))

    def step(st, active):
        mem = opt_holder["mem"] if warm else _zero_mem()
        st2, stats, mem2 = vstep(st, mem)
        if warm:
            opt_holder["mem"] = mem2
        return st2, np.asarray(st2.ind_lkl), np.asarray(stats.fwbw_maxdiff)

    def freeze(new_states, old_states, active):
        # converged replicates' stepped state is discarded, like an
        # independent run that already exited its loop
        mask = jnp.asarray(active)

        def sel(new, old):
            m = mask.reshape((R,) + (1,) * (new.ndim - 1))
            return jnp.where(m, new, old)

        return jax.tree.map(sel, new_states, old_states)

    cb = checkpoint_cb
    if checkpoint_cb is not None and warm:

        def cb(n_iter, st, bkd):
            bkd = dict(bkd)
            bkd["opt_mem"] = tuple(
                np.asarray(x) for x in opt_holder["mem"]
            )
            checkpoint_cb(n_iter, st, bkd)

    states, bk, _ = convergence_loop(
        step,
        states,
        opts,
        n_ind=N,
        n_rep=R,
        freeze=freeze,
        log_callback=log_callback,
        trace=trace,
        checkpoint_cb=cb,
        resume_bookkeeping=resume_bookkeeping,
    )
    tot, iters_done = bk.tot, bk.iters_done

    best_rep = int(np.argmax(tot))
    best_state = jax.tree.map(lambda x: x[best_rep], states)
    path, _ = viterbi(
        best_state.e_prob,
        dist,
        best_state.indF,
        best_state.alpha,
        compat=opts.viterbi_compat,
    )
    best = EMResult(
        state=best_state,
        path=np.asarray(path),
        tot_lkl=tot[best_rep],
        n_iters=int(iters_done[best_rep]),
        converged=bool(iters_done[best_rep] < opts.max_iters),
        lkl_history=[],
    )
    return RestartResult(
        best=best,
        best_rep=best_rep,
        rep_lkl=tot.copy(),
        rep_iters=iters_done.copy(),
    )
