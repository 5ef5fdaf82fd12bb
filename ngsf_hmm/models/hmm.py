"""Two-state HMM recursions as batched site scans.

Accelerator reformulation of the reference's per-individual sequential
recursions (reference: shared/HMM.cpp:6-125): every kernel here processes
ALL individuals per scan step (the pthread per-individual fan-out,
EM.cpp:151-159, becomes a batch axis), and the site axis is a
``lax.scan``. Blocked / associative-scan variants that cut the sequential
depth live in hmm_blocked.py.

Conventions (0-based; the reference's 1-based sentinel is dropped at I/O):
 - e_prob: [S, N, 2]   log emissions, site-major
 - dist:   [S]         distance (Mb) from previous site; dist[0] is the
                       first site's absolute coordinate (read_data.cpp:199-205
                       quirk) and chromosome breaks are +inf
 - F, alpha: [N]
 - fw/bw:  [S, N, 2]   log forward/backward values
"""

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.logsum import logsum2
from ..ops.transitions import log_q


def _log_trans_elems(F, alpha, dist_s):
    """Per-individual log transition matrix entries for one step.

    Returns (lt00, lt01, lt10, lt11), each [N]. T[k,l] = (1-x) q_l + delta x,
    x = exp(-alpha * d) (HMM.cpp:130-139).

    Chromosome breaks (d = +inf) collapse to the stationary distribution
    (x = 0); the double-where keeps d/dalpha finite there (inf * 0 = NaN
    otherwise), which the M-step autodiff needs.
    """
    is_break = jnp.isinf(dist_s)
    d_safe = jnp.where(is_break, 1.0, dist_s)
    x = jnp.where(is_break, 0.0, jnp.exp(-alpha * d_safe))
    one_m = 1.0 - x
    q0 = 1.0 - F
    q1 = F
    lt00 = jnp.log(one_m * q0 + x)
    lt01 = jnp.log(one_m * q1)
    lt10 = jnp.log(one_m * q0)
    lt11 = jnp.log(one_m * q1 + x)
    return lt00, lt01, lt10, lt11


def forward(e_prob, dist, F, alpha):
    """Log-space forward pass (HMM.cpp:6-28).

    Returns (fw [S, N, 2], loglik [N]); loglik = logsum(fw[S-1]).
    """

    def step(carry, xs):
        e_s, d_s = xs
        lt00, lt01, lt10, lt11 = _log_trans_elems(F, alpha, d_s)
        c0, c1 = carry[:, 0], carry[:, 1]
        n0 = logsum2(c0 + lt00, c1 + lt10) + e_s[:, 0]
        n1 = logsum2(c0 + lt01, c1 + lt11) + e_s[:, 1]
        new = jnp.stack([n0, n1], axis=-1)
        return new, new

    init = jnp.broadcast_to(log_q(F), (F.shape[0], 2))
    _, fw = jax.lax.scan(step, init, (e_prob, dist))
    loglik = logsum2(fw[-1, :, 0], fw[-1, :, 1])
    return fw, loglik


def forward_loglik(F, alpha, e_prob, dist):
    """Forward total log-likelihood only (differentiable; no fw storage).

    This is the (vector-valued, per-individual) objective the reference's
    BFGS M-step maximises via repeated full forward passes
    (EM.cpp:449-464); here it is a single scan whose gradient comes from
    autodiff instead of central differences.
    """

    def step(carry, xs):
        e_s, d_s = xs
        lt00, lt01, lt10, lt11 = _log_trans_elems(F, alpha, d_s)
        c0, c1 = carry[:, 0], carry[:, 1]
        n0 = logsum2(c0 + lt00, c1 + lt10) + e_s[:, 0]
        n1 = logsum2(c0 + lt01, c1 + lt11) + e_s[:, 1]
        return jnp.stack([n0, n1], axis=-1), None

    init = jnp.broadcast_to(log_q(F), (F.shape[0], 2))
    last, _ = jax.lax.scan(step, init, (e_prob, dist))
    return logsum2(last[:, 0], last[:, 1])


def loglik_value_and_grad(F, alpha, e_prob, dist):
    """Analytic (loglik, dL/dF, dL/dalpha), each [N], via forward-backward.

    Reverse-mode autodiff through a 100k+-step ``lax.scan`` is ~1000x
    slower than the scan itself (residual-replay bound), and the
    reference instead burns 2n extra forward passes on central
    differences (bfgs.cpp:22-65). Neither is needed: by the Fisher
    identity the HMM log-likelihood gradient is the posterior expectation
    of the transition-score gradients,

      dL/dtheta = sum_s sum_{k,l} xi_s(k,l) d(log T_s[k,l])/dtheta
                + sum_k gamma_init(k) d(log q[k])/dtheta,

    with pairwise posteriors xi_s(k,l) = exp(fw_{s-1}[k] + log T_s[k,l]
    + e_s[l] + bw_s[l] - L) and fw_{-1} = log q. Cost: one forward + one
    backward scan + fused elementwise passes.

    Implemented division-free: xi_s(k,l) d(log T)/dtheta = u_s(k,l)
    dT/dtheta with u_s(k,l) = exp(fw_{s-1}[k] + e_s[l] + bw_s[l] - L)
    (the pairwise posterior WITHOUT its transition factor), so parameter
    values pinned at the box bounds (F ~ 1e-15, alpha ~ 0) never produce
    0/0. Closed-form dT (x = exp(-alpha d), dx = d*x; both 0 at
    chromosome breaks d = inf):
      T      = [[(1-x)(1-F)+x, (1-x)F], [(1-x)(1-F), (1-x)F+x]]
      dT/dF  = (1-x) * [[-1, 1], [-1, 1]]
      dT/da  = dx * [[-F, F], [1-F, -(1-F)]]
    Initial-distribution term: dL/dF += -w0 + w1 with
    w_k = sum_l T_0[k,l] exp(e_0[l] + bw_0[l] - L) (since dq/dF = [-1, 1]).
    """
    fw, L = forward(e_prob, dist, F, alpha)
    bw, _ = backward(e_prob, dist, F, alpha)

    lq = log_q(F)  # [N, 2]
    fw_prev = jnp.concatenate([jnp.broadcast_to(lq, (1,) + lq.shape), fw[:-1]])

    is_break = jnp.isinf(dist)[:, None]  # [S, 1]
    d_safe = jnp.where(is_break, 1.0, dist[:, None])
    x = jnp.where(is_break, 0.0, jnp.exp(-alpha[None, :] * d_safe))  # [S, N]
    dx = jnp.where(is_break, 0.0, d_safe * x)  # d * exp(-alpha d)
    one_m = 1.0 - x
    Fb = F[None, :]

    # u_s(k,l), [S, N] each.
    b = e_prob + bw - L[None, :, None]  # [S, N, 2]
    u00 = jnp.exp(fw_prev[:, :, 0] + b[:, :, 0])
    u01 = jnp.exp(fw_prev[:, :, 0] + b[:, :, 1])
    u10 = jnp.exp(fw_prev[:, :, 1] + b[:, :, 0])
    u11 = jnp.exp(fw_prev[:, :, 1] + b[:, :, 1])

    gF = (one_m * (-u00 + u01 - u10 + u11)).sum(0)
    ga = (dx * (Fb * (u01 - u00) + (1.0 - Fb) * (u10 - u11))).sum(0)

    # Initial-distribution term (dq0/dF = -1, dq1/dF = +1).
    T00_0 = one_m[0] * (1.0 - F) + x[0]
    T01_0 = one_m[0] * F
    T10_0 = one_m[0] * (1.0 - F)
    T11_0 = one_m[0] * F + x[0]
    eb0 = jnp.exp(b[0])  # [N, 2]
    w0 = T00_0 * eb0[:, 0] + T01_0 * eb0[:, 1]
    w1 = T10_0 * eb0[:, 0] + T11_0 * eb0[:, 1]
    gF = gF + (w1 - w0)
    return L, gF, ga


def backward(e_prob, dist, F, alpha):
    """Log-space backward pass (HMM.cpp:33-60).

    Returns (bw [S, N, 2], loglik [N]) where loglik is the backward-side
    total used by the reference's Fw/Bw consistency check (EM.cpp:166-170).
    """
    S, N = e_prob.shape[0], e_prob.shape[1]

    def step(carry, xs):
        e_s, d_s = xs
        lt00, lt01, lt10, lt11 = _log_trans_elems(F, alpha, d_s)
        b0, b1 = carry[:, 0], carry[:, 1]
        p0 = logsum2(lt00 + e_s[:, 0] + b0, lt01 + e_s[:, 1] + b1)
        p1 = logsum2(lt10 + e_s[:, 0] + b0, lt11 + e_s[:, 1] + b1)
        new = jnp.stack([p0, p1], axis=-1)
        return new, new

    init = jnp.zeros((N, 2), dtype=e_prob.dtype)
    bw0_carry, ys = jax.lax.scan(
        step, init, (e_prob[1:], dist[1:]), reverse=True
    )
    bw = jnp.concatenate([ys, init[None]], axis=0) if S > 1 else init[None]

    # Sentinel step: fold in site 0's emission and the stationary prior
    # (HMM.cpp:40-56 at s=1 plus the final += log(q)).
    lt00, lt01, lt10, lt11 = _log_trans_elems(F, alpha, dist[0])
    b0, b1 = bw[0, :, 0], bw[0, :, 1]
    s0 = logsum2(lt00 + e_prob[0, :, 0] + b0, lt01 + e_prob[0, :, 1] + b1)
    s1 = logsum2(lt10 + e_prob[0, :, 0] + b0, lt11 + e_prob[0, :, 1] + b1)
    lq = log_q(F)
    loglik = logsum2(s0 + lq[:, 0], s1 + lq[:, 1])
    return bw, loglik


def posteriors(e_prob, dist, F, alpha):
    """Forward-backward E-step: per-site IBD posterior and log-likelihoods.

    Returns (p_ibd [S, N], loglik_fw [N], loglik_bw [N]). p_ibd is the
    state-1 marginal exp(fw + bw - loglik), NOT yet snapped by
    check_interv (callers apply it; EM.cpp:178-185).
    """
    fw, ll_f = forward(e_prob, dist, F, alpha)
    bw, ll_b = backward(e_prob, dist, F, alpha)
    p_ibd = jnp.exp(fw[:, :, 1] + bw[:, :, 1] - ll_f[None, :])
    return p_ibd, ll_f, ll_b


@partial(jax.jit, static_argnames=("compat",))
def viterbi(e_prob, dist, F, alpha, compat=True, init_logits=None,
            final_state=None):
    """Most-probable state path.

    compat=True replicates the reference's production Viterbi
    (HMM.cpp:98-125) including its in-place update: within a site, the
    state-1 maximisation over predecessor k=0 uses the ALREADY-UPDATED
    state-0 score (which includes this site's state-0 emission). The
    textbook variant (compat=False) matches the unused viterbi_NEW
    (HMM.cpp:62-95).

    init_logits [N, 2] / final_state [N]: boundary constraints for
    site-sharded decoding (parallel/site_sharded.py): override the
    stationary log q init and/or force the traceback to start from a
    given final state (the globally-optimal state at the shard's right
    boundary).

    Returns (path [S, N] int8, best score [N]).
    """

    def step(carry, xs):
        e_s, d_s = xs
        lt00, lt01, lt10, lt11 = _log_trans_elems(F, alpha, d_s)
        v0, v1 = carry[:, 0], carry[:, 1]

        a0 = v0 + lt00
        b0 = v1 + lt10
        bp0 = (b0 > a0).astype(jnp.int8)  # strict >: ties keep k=0
        n0 = jnp.maximum(a0, b0) + e_s[:, 0]

        # compat: state-1's k=0 candidate uses the in-place-updated n0
        # (already containing e_s[:, 0]); textbook uses the buffered v0.
        a1 = (n0 if compat else v0) + lt01
        b1 = v1 + lt11
        bp1 = (b1 > a1).astype(jnp.int8)
        n1 = jnp.maximum(a1, b1) + e_s[:, 1]

        new = jnp.stack([n0, n1], axis=-1)
        return new, jnp.stack([bp0, bp1], axis=-1)

    if init_logits is None:
        init = jnp.broadcast_to(log_q(F), (F.shape[0], 2))
    else:
        init = init_logits
    vp, bp = jax.lax.scan(step, init, (e_prob, dist))  # bp: [S, N, 2]

    if final_state is None:
        last = (vp[:, 1] > vp[:, 0]).astype(jnp.int8)  # strict > tie rule
    else:
        last = final_state.astype(jnp.int8)
    score = jnp.where(last == 1, vp[:, 1], vp[:, 0])

    def traceback(carry, bp_s):
        # carry = path[s]; emit it, step to path[s-1] = bp[s][path[s]]
        prev = jnp.take_along_axis(
            bp_s, carry[:, None].astype(jnp.int32), axis=-1
        )[:, 0].astype(jnp.int8)
        return prev, carry

    if e_prob.shape[0] > 1:
        path0, ys = jax.lax.scan(traceback, last, bp[1:], reverse=True)
        path = jnp.concatenate([path0[None], ys], axis=0)
    else:
        path = last[None]
    return path, score
