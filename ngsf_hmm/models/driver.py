"""The ONE host-side EM convergence loop, shared by every engine mode.

The reference has a single training loop (reference: EM.cpp:27-135) whose
convergence gate (EM.cpp:56) combines a total-likelihood decrease test, a
per-individual relative-epsilon test, min/max iteration bounds and the
SIG_COND graceful-stop flag.  Round 1 replicated that gate in three
hand-synchronised host loops (single-run, lockstep multi-restart,
streaming); this module extracts it into one parametrised driver so the
gate, the Fw/Bw consistency check (EM.cpp:166-170), checkpointing and the
stdout trace exist in exactly one place.

A "step" is any callable advancing the opaque engine state by one EM
iteration:

    step(state, active) -> (new_state, ind_lkl, fwbw_maxdiff)

where ``ind_lkl`` is a host [R, N] array of per-individual forward
log-likelihoods and ``fwbw_maxdiff`` a host [R] array (R = 1 in scalar
mode).  The driver owns all convergence bookkeeping; callers adapt the
result/trace/checkpoint payloads to their public schemas.
"""

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from ..utils.signals import stop_requested


def array_max_pos(a: np.ndarray) -> int:
    """First index of the strict maximum, NaN-insensitive like the
    reference's array_max_pos (gen_func.cpp:73-84)."""
    res, best = 0, -np.inf
    for i, v in enumerate(a):
        if v > best:
            res, best = i, v
    return res


@dataclasses.dataclass
class LoopBookkeeping:
    """Host convergence state; [R]-shaped (R = 1 in scalar mode)."""

    n_iter: int
    prev_tot: np.ndarray  # [R]
    tot: np.ndarray  # [R]
    prev_ind: np.ndarray  # [R, N]
    max_eps: np.ndarray  # [R]
    iters_done: np.ndarray  # [R] int64
    history: list  # per-iteration total lkl (scalar callers)

    @classmethod
    def fresh(cls, R, N):
        return cls(
            n_iter=0,
            prev_tot=np.zeros(R),
            tot=np.zeros(R),
            prev_ind=np.full((R, N), -np.inf),
            max_eps=np.full(R, -np.inf),
            iters_done=np.zeros(R, dtype=np.int64),
            history=[],
        )

    def to_dict(self, scalar: bool) -> dict:
        """The checkpoint schema (io/checkpoint.py): scalar runs store
        floats + a history list, replicate runs store [R] arrays + the
        active set (recomputed on load, stored for inspection)."""
        if scalar:
            return {
                "n_iter": self.n_iter,
                "prev_tot": float(self.prev_tot[0]),
                "tot": float(self.tot[0]),
                "prev_ind": self.prev_ind[0],
                "max_eps": float(self.max_eps[0]),
                "history": self.history,
            }
        return {
            "n_iter": self.n_iter,
            "prev_tot": self.prev_tot,
            "tot": self.tot,
            "prev_ind": self.prev_ind,
            "max_eps": self.max_eps,
            "iters_done": self.iters_done,
        }

    @classmethod
    def from_dict(cls, bk: dict, R: int, N: int, scalar: bool):
        if scalar:
            prev_ind = np.asarray(bk["prev_ind"], np.float64).reshape(1, N)
            n_iter = int(bk["n_iter"])
            return cls(
                n_iter=n_iter,
                prev_tot=np.array([float(bk["prev_tot"])]),
                tot=np.array([float(bk["tot"])]),
                prev_ind=prev_ind,
                max_eps=np.array([float(bk["max_eps"])]),
                iters_done=np.full(1, n_iter, dtype=np.int64),
                history=list(bk.get("history", [])),
            )
        prev_ind = np.asarray(bk["prev_ind"], np.float64)
        if prev_ind.shape != (R, N):
            raise RuntimeError(
                f"restart checkpoint bookkeeping is {prev_ind.shape}, "
                f"run is {R} replicates x {N} ind"
            )
        iters_done = np.asarray(bk["iters_done"], np.int64)
        if iters_done.shape != (R,):
            raise RuntimeError(
                f"restart checkpoint bookkeeping is {prev_ind.shape}, "
                f"run is {R} replicates x {N} ind"
            )
        return cls(
            n_iter=int(bk["n_iter"]),
            prev_tot=np.asarray(bk["prev_tot"], np.float64).copy(),
            tot=np.asarray(bk["tot"], np.float64).copy(),
            prev_ind=prev_ind.copy(),
            max_eps=np.asarray(bk["max_eps"], np.float64).copy(),
            iters_done=iters_done.copy(),
            history=list(bk.get("history", [])),
        )


def fwbw_tolerance(abs_tol, dtype, ind_lkl):
    """Largest accepted |forward - backward| log-likelihood gap: the
    reference's absolute tolerance (EM.cpp:166-170), or 32 ulps of the
    largest |lkl| in the precision the chains ran in, whichever is
    larger. In f64 the ulp term is ~1e-8 at any realistic likelihood,
    so the reference's check is unchanged; in f32 a 1M-site chain's
    log-likelihood (~-5e5) has an ulp of 0.06, above the reference's
    0.001, and the two directions sum their block offsets in different
    orders."""
    scale = float(np.max(np.abs(ind_lkl)))
    if not np.isfinite(scale):
        return abs_tol
    return max(abs_tol, 32.0 * float(np.finfo(dtype).eps) * scale)


def convergence_loop(
    step: Callable,
    state,
    opts,
    n_ind: int,
    n_rep: Optional[int] = None,
    freeze: Optional[Callable] = None,
    log_callback=None,
    trace=None,
    checkpoint_cb=None,
    resume_bookkeeping: Optional[dict] = None,
    track_history: bool = False,
):
    """Run ``step`` to convergence under the EM.cpp:56 gate.

    n_rep: None = scalar mode (single run; callbacks see scalar totals),
        int R = lockstep replicates with per-replicate convergence.
    freeze(new_state, old_state, active [R] bool) -> state: in replicate
        mode, keeps converged replicates' state fixed while stragglers
        step (an already-exited independent run would not advance).
    log_callback(n_iter, state, tot): the --log N rewrite hook, invoked
        at the TOP of each iteration (EM.cpp:59-63); tot is a float in
        scalar mode, an [R] array otherwise.
    trace(event, **kw): stdout-parity hook; "iter_start" carries n_iter,
        "iter_done" carries n_iter/tot_lkl/max_eps/dt/ind_lkl/ind_eps/
        imax/state/active (scalar values in scalar mode).
    checkpoint_cb(n_iter, state, bookkeeping_dict): invoked after every
        iteration with the legacy checkpoint schema (LoopBookkeeping
        .to_dict); resume_bookkeeping: such a dict to continue from.
        The active set is re-derived from the restored stats and the
        CURRENT options, so a resume with a raised --max_iters or a
        lowered --min_epsilon keeps running.

    Returns (state, bk: LoopBookkeeping, active_at_exit [R]).
    """
    scalar = n_rep is None
    R = 1 if scalar else n_rep
    N = n_ind

    if resume_bookkeeping:
        bk = LoopBookkeeping.from_dict(resume_bookkeeping, R, N, scalar)
    else:
        bk = LoopBookkeeping.fresh(R, N)

    def keep(r):
        # the convergence gate (EM.cpp:56)
        return (
            bk.prev_tot[r] - bk.tot[r] > opts.min_epsilon
            or bk.max_eps[r] > opts.min_epsilon
            or bk.n_iter < opts.min_iters
        ) and bk.n_iter < opts.max_iters

    active = np.array([keep(r) for r in range(R)], dtype=bool)

    while active.any() and not stop_requested():
        if log_callback is not None:
            log_callback(
                bk.n_iter,
                state,
                float(bk.tot[0]) if scalar else bk.tot,
            )
        t0 = time.time()
        bk.n_iter += 1
        if trace is not None:
            trace("iter_start", n_iter=bk.n_iter)

        new_state, ind_lkl, fwbw = step(state, active)
        lkl_dtype = getattr(ind_lkl, "dtype", np.float64)
        ind_lkl = np.asarray(ind_lkl, np.float64).reshape(R, N)
        fwbw = np.asarray(fwbw, np.float64).reshape(R)

        if opts.check_fwbw:
            d = float(np.max(fwbw[active]))
            tol = fwbw_tolerance(opts.lkl_check_tol, lkl_dtype, ind_lkl)
            # NaN must abort too (the reference kills the run on NaN in
            # the recursions, HMM.cpp:18-21); `d > tol` is False for NaN
            if not np.isfinite(d) or d > tol:
                raise RuntimeError(
                    f"Fw and Bw lkl do not match (max diff {d:g})!"
                )

        if freeze is not None and not active.all():
            state = freeze(new_state, state, active)
        else:
            state = new_state

        ind_eps = np.empty((R, N))
        imax = np.zeros(R, dtype=np.int64)
        for r in range(R):
            if not active[r]:
                ind_eps[r] = np.zeros(N)
                continue
            bk.iters_done[r] = bk.n_iter
            bk.prev_tot[r] = bk.tot[r]
            bk.tot[r] = float(ind_lkl[r].sum())
            with np.errstate(invalid="ignore"):
                eps = (ind_lkl[r] - bk.prev_ind[r]) / np.abs(bk.prev_ind[r])
            ind_eps[r] = eps
            imax[r] = array_max_pos(eps)
            bk.max_eps[r] = eps[imax[r]]
            bk.prev_ind[r] = ind_lkl[r]
        if track_history:
            bk.history.append(float(bk.tot[0]) if scalar else bk.tot.copy())

        prev_active = active.copy()
        active = prev_active & np.array(
            [keep(r) for r in range(R)], dtype=bool
        )

        if checkpoint_cb is not None:
            d = bk.to_dict(scalar)
            if not scalar:
                d["active"] = active
            checkpoint_cb(bk.n_iter, state, d)
        if trace is not None:
            if scalar:
                trace(
                    "iter_done",
                    n_iter=bk.n_iter,
                    tot_lkl=float(bk.tot[0]),
                    max_eps=float(bk.max_eps[0]),
                    dt=time.time() - t0,
                    ind_lkl=ind_lkl[0],
                    ind_eps=ind_eps[0],
                    imax=int(imax[0]),
                    state=state,
                )
            else:
                trace(
                    "iter_done",
                    n_iter=bk.n_iter,
                    tot_lkl=bk.tot.copy(),
                    max_eps=bk.max_eps.copy(),
                    dt=time.time() - t0,
                    ind_lkl=ind_lkl,
                    ind_eps=ind_eps,
                    imax=imax,
                    state=state,
                    active=prev_active,
                )

    return state, bk, active
