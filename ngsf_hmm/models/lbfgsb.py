"""Batched box-constrained L-BFGS for the per-individual (F, alpha) M-step.

The reference hands each individual's 2-parameter problem to a serial
L-BFGS-B 2.1 (f2c) with central-difference gradients, re-running a full
forward pass per function evaluation (reference: EM.cpp:423-439,
shared/bfgs.cpp:83-138, MVAL=10 / FACTR=1e6 / PGTOL=1e-3 at bfgs.h:23-25).

Accelerator redesign: ALL individuals are optimised simultaneously by one
projected L-BFGS whose state carries a batch axis -- every line-search
probe is a single batched value-and-grad evaluation (one HMM pass over all
individuals), and gradients come from the analytic Fisher-identity form
instead of 2n extra forward passes. Individuals converge independently via
masking. The full step t = 1 is probed first (it is usually accepted, so
one pass per outer iteration covers both the search and the next
gradient); rejections backtrack by safeguarded quadratic interpolation.

Algorithmic notes vs upstream L-BFGS-B: this uses gradient projection with
an active-set-masked two-loop recursion and a projected-path Armijo
backtracking search (quadratic interpolation, Nocedal & Wright 3.5) rather
than the exact generalized-Cauchy-point + subspace minimisation of
Byrd/Lu/Nocedal/Zhu; stopping criteria (projected-gradient inf-norm <=
pgtol, relative f-decrease <= factr * eps_mach) match. For n=2 smooth
problems both converge to the same box-constrained optimum.

Fixed parameters (--indF_fixed / --alpha_fixed) are expressed exactly as
the reference does -- by pinning lower == upper == x0 (EM.cpp:429-436).

ONE algorithm, two execution backends sharing `_lbfgsb_core`:
  - `lbfgsb_minimize`: jnp arrays + `lax.while_loop`, traceable inside the
    jitted EM iteration (models/em.py, parallel/site_sharded.py).
  - `lbfgsb_minimize_host`: np arrays + Python loops, for objectives that
    stream host-resident data and therefore cannot be traced
    (models/streaming.py). Identical update rules by construction.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

MVAL = 10
FACTR = 1e6
PGTOL = 1e-3
EPS_MACH = 2.220446049250313e-16
# Line-search round cap (the reference's dcsrch caps at 20 evaluations,
# bfgs.h:26 MAXFEV-class guard). The noise-floor gate below (not this
# cap) is what retires rows whose achievable decrease is below the
# dtype's resolution -- the cap only bounds GENUINE backtracks, which
# quadratic interpolation usually finishes in 1-2 rounds, so 10 rounds
# (t down to 1e-10) is cheap insurance for narrow valleys (e.g. the
# called-genotype one-hot likelihoods, golden TG configs).
MAX_LS = 10
ARMIJO_C1 = 1e-4


class _State(NamedTuple):
    x: jnp.ndarray  # [B, n]
    f: jnp.ndarray  # [B]
    g: jnp.ndarray  # [B, n]
    S: jnp.ndarray  # [m, B, n]  history of steps s_j
    Y: jnp.ndarray  # [m, B, n]  history of grad diffs y_j
    valid: jnp.ndarray  # [m, B] bool
    head: jnp.ndarray  # [B] int32, PER-ROW next ring-buffer slot
    active: jnp.ndarray  # [B] bool
    it: jnp.ndarray  # scalar int32


def _slot_gather(xp, A, j):
    """A [m, B, ...], j [B] -> A[j[b], b] for every row b."""
    if A.ndim == 3:
        return xp.take_along_axis(A, j[None, :, None], axis=0)[0]
    return xp.take_along_axis(A, j[None, :], axis=0)[0]


def _two_loop(xp, g, S, Y, valid, head, m):
    """Batched two-loop recursion: d = -H g restricted to valid history.

    Written against `xp` (numpy or jax.numpy); the slot loop is a Python
    loop over the static history length m (unrolled in the jit trace),
    newest stored pair first: head-1, head-2, ... PER ROW (each row
    advances its own ring buffer only when it stores a pair, so a row's
    direction history -- and therefore its whole trajectory -- is
    independent of how rows are batched or sharded together).
    """
    eps = 1e-12

    q = g
    alphas = []
    for i in range(m):
        j = (head - 1 - i) % m
        s = _slot_gather(xp, S, j)
        y = _slot_gather(xp, Y, j)
        v = _slot_gather(xp, valid, j)
        sy = xp.sum(s * y, axis=-1)
        rho = xp.where(v & (sy > eps), 1.0 / xp.where(sy == 0, 1.0, sy), 0.0)
        a = rho * xp.sum(s * q, axis=-1)
        q = q - a[:, None] * y * xp.where(v, 1.0, 0.0)[:, None]
        alphas.append((j, a, s, y, v, rho))

    # H0 scaling from the newest stored pair
    j_new = (head - 1) % m
    s_n = _slot_gather(xp, S, j_new)
    y_n = _slot_gather(xp, Y, j_new)
    v_n = _slot_gather(xp, valid, j_new)
    yy = xp.sum(y_n * y_n, axis=-1)
    sy = xp.sum(s_n * y_n, axis=-1)
    gamma = xp.where(v_n & (yy > eps), sy / xp.where(yy == 0, 1.0, yy), 1.0)
    gamma = xp.clip(gamma, 1e-8, 1e8)
    r = gamma[:, None] * q

    for j, a, s, y, v, rho in reversed(alphas):
        b = rho * xp.sum(y * r, axis=-1)
        r = r + (a - b)[:, None] * s * xp.where(v, 1.0, 0.0)[:, None]
    return -r


def _py_while(cond, body, val):
    while cond(val):
        val = body(val)
    return val


def _lbfgsb_core(
    xp,
    while_loop,
    x0,
    lower,
    upper,
    m: int,
    max_iters: int,
    pgtol: float,
    factr: float,
    value_and_grad: Callable,
    warm=None,
    noise_eps=None,
    f0g0=None,
):
    """Backend-agnostic projected L-BFGS. See `lbfgsb_minimize` for the
    argument contract; `xp` is numpy or jax.numpy, `while_loop` is
    lax.while_loop or a Python loop. Every probe goes
    through `value_and_grad`; there is no value-only evaluation path.

    f0g0: optional precomputed (f, g) AT x0 (after the box clip) -- the
    streaming engine's pass A evaluates the chain at exactly x0 anyway,
    so seeding skips one full value-and-grad stream per EM iteration.
    The values must equal what value_and_grad(x0) would return; the
    trajectory is then unchanged.

    warm: optional curvature memory (S [m, B, n], Y, valid [m, B],
    head [B]) from a previous solve of a NEARBY objective (the EM outer
    loop: the forward likelihood changes only through the damped e_prob
    update, so the previous iteration's Hessian approximation is a
    near-perfect preconditioner). The first two-loop direction is then
    quasi-Newton instead of steepest descent, and the speculative t = 1
    probe typically ends the whole M-step in 1-3 value-and-grad passes.
    Returns (x, f, it, (S, Y, valid, head)). The ring-buffer head is
    PER-ROW [B] and advances only when that row stores a curvature
    pair, so every row's direction history -- and therefore its whole
    trajectory -- is independent of how rows are batched or sharded
    together (single device, ind-mesh shards, vmapped replicates all
    produce identical per-individual results in exact arithmetic), and
    the memory shards/gathers like S/Y across checkpoints and
    resharding resumes."""
    B, n = x0.shape
    dtype = x0.dtype
    x0 = xp.clip(x0, lower, upper)

    f0, g0 = f0g0 if f0g0 is not None else value_and_grad(x0)

    def proj(x):
        return xp.clip(x, lower, upper)

    def pg_norm(x, g):
        return xp.max(xp.abs(proj(x - g) - x), axis=-1)

    # dtype-aware noise floor: in f32 at HMM likelihood scale (|f| ~ 1e4
    # per individual) neither PGTOL = 1e-3 nor factr*eps(f64) relative
    # decreases are resolvable -- without a floor, noise-level rows
    # re-run the whole backtracking ladder every EM iteration. A row
    # whose achievable decrease is below ~8 ulps of f is done.
    # noise_eps: override when the OBJECTIVE is computed at a coarser
    # precision than x0 (the streaming host mirror optimizes float64
    # vectors over f32 device kernels -- the floor must reflect the
    # objective's resolution, or noise rows ride the ladder).
    eps_dt = float(noise_eps or np.finfo(dtype).eps)
    noise_rel = max(factr * EPS_MACH, 8.0 * eps_dt)

    if warm is None:
        S0 = xp.zeros((m, B, n), dtype)
        Y0 = xp.zeros((m, B, n), dtype)
        valid0 = xp.zeros((m, B), bool)
        head0 = xp.zeros((B,), xp.int32)
    else:
        S0, Y0, valid0, head_in = warm
        # per-row heads; accept a scalar (legacy checkpoints) broadcast
        head0 = xp.zeros((B,), xp.int32) + xp.asarray(head_in, xp.int32)

    init = _State(
        x=x0,
        f=f0,
        g=g0,
        S=S0,
        Y=Y0,
        valid=valid0,
        head=head0,
        active=pg_norm(x0, g0) > pgtol,
        it=xp.asarray(0, xp.int32),
    )

    def cond(st: _State):
        return xp.any(st.active) & (st.it < max_iters)

    # Freeze slack: a coordinate PRACTICALLY at a bound (within 1e-9 of
    # the box width) pressing outward behaves as pinned -- the reference
    # Cauchy scan fixes such variables the instant its path touches the
    # bound (bfgs.cpp cauchy_). Without the slack, a coordinate a few
    # 1e-10 above its bound keeps dominating the search direction, the
    # backtracking ladder snaps to its near-zero breakpoint every round,
    # and the row retires with a live gradient in the OTHER coordinate
    # (multi-chromosome golden surfaces: F stalled at its init).
    # widened to the objective's resolution on coarse-precision paths
    # (the streamed host M-step optimizes f64 vectors over f32 device
    # kernels: its trajectories park near-bound coordinates ~1e-7 away)
    bnd_eps = max(1e-9, eps_dt) * (upper - lower)

    def body(st: _State):
        # freeze bound-pinned coordinates whose gradient points outward
        at_lo = (st.x <= lower + bnd_eps) & (st.g > 0)
        at_hi = (st.x >= upper - bnd_eps) & (st.g < 0)
        frozen = at_lo | at_hi
        g_eff = xp.where(frozen, 0.0, st.g)

        d = _two_loop(xp, g_eff, st.S, st.Y, st.valid, st.head, m)
        d = xp.where(frozen, 0.0, d)
        # fall back to steepest descent when d is not a descent direction
        descent = xp.sum(d * g_eff, axis=-1) < 0
        d = xp.where(descent[:, None], d, -g_eff)
        # Breakpoint of the projected path (first bound any moving
        # coordinate reaches, in step units) -- the batched stand-in for
        # the reference L-BFGS-B's generalized-Cauchy-point breakpoint
        # scan (bfgs.cpp cauchy_). Used two ways below: the backtracking
        # ladder SNAPS to just under it (an interior Armijo point often
        # sits right below the breakpoint, ~12 plain decay rounds away),
        # and cold steepest-descent steps that overshoot it get one
        # accept-if-better interior probe (a projected full step into
        # the box corner passes Armijo but can be a frozen-transition
        # local trap; measured on the 10x10k cold-start golden configs).
        qn = descent & xp.any(st.valid, axis=0)
        dist_bp = xp.where(
            d > 0, upper - st.x, xp.where(d < 0, st.x - lower, xp.inf)
        )
        t_bp = xp.min(
            xp.where(d != 0, dist_bp / xp.where(d == 0, 1.0, xp.abs(d)),
                     xp.inf),
            axis=-1,
        ).astype(dtype)
        t_first = xp.ones((B,), dtype)

        # Armijo backtracking where EVERY probe is one batched
        # value-and-grad evaluation (one data pass): the full step t = 1
        # is probed first -- a well-scaled L-BFGS direction passes at
        # t = 1 in the vast majority of iterations, making that single
        # pass the whole line search AND the next iteration's gradient.
        # Rows that reject backtrack by safeguarded quadratic
        # interpolation (Nocedal & Wright 3.5: minimise the parabola
        # through phi(0) = f, phi'(0) = g.d, phi(t) = f_t; clip into
        # [0.1 t, 0.5 t]), which typically lands an acceptable step in
        # 1-2 extra passes instead of a fixed halving ladder.
        gd0 = xp.sum(g_eff * d, axis=-1)  # phi'(0), < 0 on descent

        def probe(t):
            x_c = proj(st.x + t[:, None] * d)
            f_c, g_c = value_and_grad(x_c)
            dec = xp.sum(st.g * (x_c - st.x), axis=-1)
            moved = xp.any(x_c != st.x, axis=-1)
            ok = (
                (f_c <= st.f + ARMIJO_C1 * dec) & moved & xp.isfinite(f_c)
            )
            return x_c, f_c, g_c, ok

        # achievable-decrease noise floor per row (see noise_rel above)
        noise_f = noise_rel * xp.maximum(xp.abs(st.f), 1.0)

        x_sp, f_sp, g_sp, ok_sp = probe(t_first)
        acc0 = st.active & ok_sp
        # don't backtrack rows whose IDEAL first-order decrease at the
        # next step is already below the noise floor -- they cannot pass
        # Armijo in this precision and would ride the full ladder
        need_rej = st.active & ~ok_sp & (-gd0 * t_first * 0.5 > noise_f)
        # cold rows whose ACCEPTED full step overshot a breakpoint take
        # one interior (just-below-breakpoint) probe and keep the better
        # f -- the corner-vs-interior basin check
        corner0 = acc0 & ~qn & (t_first > t_bp)
        need0 = need_rej | corner0

        def bt_round(ls):
            t, f_t, x_new, f_new, g_new, need, rounds = ls
            # quadratic-fit minimiser, safeguarded into [0.1 t, 0.5 t]
            denom = 2.0 * (f_t - st.f - gd0 * t)
            t_q = xp.where(
                denom > 0.0,
                -gd0 * t * t / xp.where(denom == 0.0, 1.0, denom),
                0.5 * t,
            )
            t_new = xp.clip(t_q, 0.1 * t, 0.5 * t)
            t_new = xp.where(xp.isfinite(t_new), t_new, 0.5 * t)
            # snap to just under the projected path's first breakpoint
            # instead of decaying past it round by round
            t_new = xp.where(
                (t > t_bp) & (t_new > 0.95 * t_bp), 0.95 * t_bp, t_new
            )
            x_c, f_c, g_c, ok = probe(t_new)
            # accept-if-better: corner-check rows already hold an
            # accepted point in f_new; plain rejected rows hold st.f,
            # which any Armijo-passing probe beats by construction
            newly = need & ok & (f_c < f_new)
            x_new = xp.where(newly[:, None], x_c, x_new)
            f_new = xp.where(newly, f_c, f_new)
            g_new = xp.where(newly[:, None], g_c, g_new)
            rounds = rounds + 1
            need = (
                need & ~ok & (t_new > 1e-12) & (rounds < MAX_LS)
                & (-gd0 * t_new * 0.5 > noise_f)
            )
            return (t_new, f_c, x_new, f_new, g_new, need, rounds)

        bt0 = (
            t_first,
            f_sp,
            xp.where(acc0[:, None], x_sp, st.x),
            xp.where(acc0, f_sp, st.f),
            xp.where(acc0[:, None], g_sp, st.g),
            need0,
            xp.asarray(0, xp.int32),
        )
        _, _, x_new, f_new, g_new, _, _ = while_loop(
            lambda ls: xp.any(ls[5]), bt_round, bt0
        )
        # keep previous values for inactive rows
        x_new = xp.where(st.active[:, None], x_new, st.x)
        f_new = xp.where(st.active, f_new, st.f)
        g_new = xp.where(st.active[:, None], g_new, st.g)

        s_vec = x_new - st.x
        y_vec = g_new - st.g
        sy = xp.sum(s_vec * y_vec, axis=-1)
        store = st.active & (sy > 1e-12)
        # per-row ring-buffer write: row b stores into slot head[b] % m
        # and advances ITS head only when it stores (layout-invariant
        # histories; see _two_loop)
        slot = st.head % m  # [B]
        wmask = (
            xp.arange(m, dtype=xp.int32)[:, None] == slot[None, :]
        ) & store[None, :]  # [m, B]
        S = xp.where(wmask[:, :, None], s_vec[None, :, :], st.S)
        Y = xp.where(wmask[:, :, None], y_vec[None, :, :], st.Y)
        valid = xp.where(wmask, True, st.valid)
        head = st.head + store.astype(xp.int32)

        small_pg = pg_norm(x_new, g_new) <= pgtol
        rel_dec = (st.f - f_new) <= noise_rel * xp.maximum(
            xp.maximum(xp.abs(st.f), xp.abs(f_new)), 1.0
        )
        no_move = xp.all(s_vec == 0, axis=-1)
        active = st.active & ~small_pg & ~(rel_dec | no_move)

        return _State(
            x_new, f_new, g_new, S, Y, valid, head, active, st.it + 1
        )

    out = while_loop(cond, body, init)
    return out.x, out.f, out.it, (out.S, out.Y, out.valid, out.head)


def lbfgsb_minimize(
    fun: Callable,
    x0: jnp.ndarray,
    lower: jnp.ndarray,
    upper: jnp.ndarray,
    m: int = MVAL,
    max_iters: int = 60,
    pgtol: float = PGTOL,
    factr: float = FACTR,
    value_and_grad: Callable | None = None,
    fun_multi: Callable | None = None,
    warm=None,
    return_memory: bool = False,
    noise_eps=None,
    f0g0=None,
):
    """Minimise a batched objective within box bounds (traceable/jittable).

    fun: x [B, n] -> f [B]  (independent per batch row; autodiff-able)
    x0, lower, upper: [B, n]
    value_and_grad: optional x -> (f [B], g [B, n]) override; supply an
        analytic gradient (e.g. hmm.loglik_value_and_grad) when reverse-
        mode through the objective is expensive. Every line-search probe
        is one value-and-grad evaluation (speculative full step +
        interpolated backtracking), so there is no separate value-only
        path; `fun_multi` is accepted for backward compatibility and
        ignored.
    warm: optional (S, Y, valid, head) curvature memory returned by a
        previous call (with return_memory=True) on a nearby objective --
        the EM warm start. return_memory: append that tuple to the
        return value.
    f0g0: optional precomputed (f, g) at the box-clipped x0 (see
        _lbfgsb_core) -- em_iteration's fused route seeds it from the
        E-step's transfer+tangent stream, skipping the optimizer's
        initial evaluation. Values must equal value_and_grad(x0)'s.
    Returns (x_opt [B, n], f_opt [B], n_outer_iters[, memory]).
    """
    del fun_multi
    if value_and_grad is None:

        def value_and_grad(x):
            f, vjp = jax.vjp(fun, x)
            (g,) = vjp(jnp.ones_like(f))
            return f, g

    out = _lbfgsb_core(
        jnp,
        jax.lax.while_loop,
        x0,
        lower,
        upper,
        m,
        max_iters,
        pgtol,
        factr,
        value_and_grad,
        warm=warm,
        noise_eps=noise_eps,
        f0g0=f0g0,
    )
    return out if return_memory else out[:3]


def lbfgsb_minimize_host(
    fun: Callable,
    x0: np.ndarray,
    lower: np.ndarray,
    upper: np.ndarray,
    m: int = MVAL,
    max_iters: int = 60,
    pgtol: float = PGTOL,
    factr: float = FACTR,
    value_and_grad: Callable | None = None,
    fun_multi: Callable | None = None,
    warm=None,
    return_memory: bool = False,
    noise_eps=None,
    f0g0=None,
):
    """NumPy/Python-loop backend of the SAME algorithm, for host-streamed
    objectives that cannot be traced (models/streaming.py). `fun` may be
    None when value_and_grad is supplied; `fun_multi` is accepted for
    backward compatibility and ignored (every probe is one
    value-and-grad pass). warm/return_memory as in lbfgsb_minimize;
    f0g0 as in _lbfgsb_core (precomputed first evaluation at
    clip(x0))."""
    del fun_multi
    if value_and_grad is None:
        raise ValueError("host backend needs an explicit value_and_grad")

    del fun
    x0 = np.asarray(x0)
    out = _lbfgsb_core(
        np,
        _py_while,
        x0,
        np.asarray(lower, x0.dtype),
        np.asarray(upper, x0.dtype),
        m,
        max_iters,
        pgtol,
        factr,
        value_and_grad,
        warm=warm,
        noise_eps=noise_eps,
        f0g0=f0g0,
    )
    return out if return_memory else out[:3]
