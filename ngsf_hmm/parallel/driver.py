"""End-to-end multi-chip EM runs: the sharded product path.

Round 1 shipped jitted sharded *step* functions (sharded_em.py,
site_sharded.py); this module drives them to convergence with the same
host loop as every other engine mode (models/driver.convergence_loop --
the EM.cpp:56 gate, Fw/Bw check, --log rewrites, checkpoint/resume) and
finishes with the matching sharded Viterbi decode, so a mesh run is a
full reference-equivalent run (reference: EM.cpp:27-135), not one step.

Mesh specs (the CLI's --mesh flag):
  "ind=8"            individuals data-parallel over 8 devices
  "restart=2,ind=4"  2-way replicate sharding x 4-way individuals
  "site=8"           sites sharded (context-parallel analog)
  "ind=2,site=4"     the 2-D grid (BASELINE 1000 x 10M layout)
  "2x4"              shorthand: restart=2, ind=4
  "1x2x4"            shorthand: restart=1, ind=2, site=4

Divisibility: the individual axis must divide n_ind evenly (individuals
cannot be padded -- a pad individual would perturb the est_maf psum);
the site axis pads transparently (pad sites enter the chain as exact
identities, see site_em_iteration).
"""

import re

import numpy as np
import jax
import jax.numpy as jnp

from ..models.driver import convergence_loop
from ..models.em import EMOptions, EMResult, EMState
from ..models.restart import RestartResult
from .distributed import host_array
from .mesh import make_mesh
from .sharded_em import (
    make_sharded_em_step,
    make_sharded_viterbi,
    shard_inputs,
    zero_opt_memory,
)
from .site_sharded import (
    make_grid_mesh,
    make_grid_sharded_em_step,
    make_grid_sharded_viterbi,
    make_site_mesh,
    make_site_sharded_em_step,
    make_site_sharded_viterbi,
    shard_grid_inputs,
    shard_site_inputs,
)


def parse_mesh_spec(spec: str) -> dict:
    """Parse a --mesh value into {"restart": r, "ind": i, "site": s}.

    Accepts "AxB" (restart x ind), "AxBxC" (restart x ind x site), or
    named comma-separated pairs "ind=4,site=2" (any order, missing axes
    default to 1).  Raises ValueError on malformed specs.
    """
    spec = spec.strip()
    out = {"restart": 1, "ind": 1, "site": 1}
    if re.fullmatch(r"\d+(x\d+){1,2}", spec):
        parts = [int(x) for x in spec.split("x")]
        out["restart"] = parts[0]
        out["ind"] = parts[1]
        if len(parts) == 3:
            out["site"] = parts[2]
    else:
        for item in spec.split(","):
            if "=" not in item:
                raise ValueError(
                    f"bad mesh spec {spec!r}: expected AxB[xC] or "
                    "axis=N pairs (axes: restart, ind, site)"
                )
            k, v = item.split("=", 1)
            k = k.strip()
            if k not in out:
                raise ValueError(
                    f"bad mesh spec {spec!r}: unknown axis {k!r} "
                    "(axes: restart, ind, site)"
                )
            try:
                out[k] = int(v)
            except ValueError:
                raise ValueError(f"bad mesh spec {spec!r}: {v!r} not an int")
    if any(v < 1 for v in out.values()):
        raise ValueError(f"bad mesh spec {spec!r}: axis sizes must be >= 1")
    if out["restart"] > 1 and out["site"] > 1:
        raise ValueError(
            "mesh axes restart and site cannot both be sharded "
            "(replicated site-sharded chains are not implemented)"
        )
    return out


def _work_dtype_for(opts: EMOptions):
    """Site-sharded kernels are the blocked-linear tier; opts.numerics
    'log' (compat) keeps them in the input dtype (f64 under x64) so big
    runs can be validated against the f64 oracle; the speed tiers run
    float32."""
    return None if opts.numerics == "log" else jnp.float32


# Exact-identity pad-site values. Every place that pads the site axis
# (here, the CLI's per-host slab loading, the distributed init mask, and
# the distributed checkpoint re-pad) MUST use these same values or the
# padded chain stops being an identity extension of the real chain:
#   PAD_GL    uniform log GLs (contribute nothing to est_maf / emissions)
#   PAD_DIST  0 distance => delta transition (state carried through)
#   PAD_E_PROB 0 in LOG space => emission prob 1 (chain passes through)
#   PAD_P_IBD 0 posterior mass on IBD at pad sites
#   PAD_FREQ  0.25 placeholder (never read back)
PAD_GL = float(np.log(1.0 / 3.0))
PAD_DIST = 0.0
PAD_E_PROB = 0.0
PAD_P_IBD = 0.0
PAD_FREQ = 0.25


def _pad_sites(gl, dist, state: EMState, S_pad: int):
    """Pad the site axis to S_pad with exact-identity sites (the PAD_*
    constants above)."""
    S = gl.shape[0]
    pad = S_pad - S
    if pad == 0:
        return gl, dist, state
    gl = jnp.concatenate(
        [gl, jnp.full((pad,) + gl.shape[1:], PAD_GL, gl.dtype)]
    )
    dist = jnp.concatenate(
        [dist, jnp.full((pad,), PAD_DIST, dist.dtype)]
    )
    state = state._replace(
        freq=jnp.concatenate(
            [state.freq, jnp.full((pad,), PAD_FREQ, state.freq.dtype)]
        ),
        e_prob=jnp.concatenate(
            [
                state.e_prob,
                jnp.full((pad,) + state.e_prob.shape[1:], PAD_E_PROB,
                         state.e_prob.dtype),
            ]
        ),
        p_ibd=jnp.concatenate(
            [state.p_ibd, jnp.full((pad,) + state.p_ibd.shape[1:],
                                   PAD_P_IBD, state.p_ibd.dtype)]
        ),
    )
    return gl, dist, state


def _unpad_state(state: EMState, S: int) -> EMState:
    return state._replace(
        freq=state.freq[:S], e_prob=state.e_prob[:S], p_ibd=state.p_ibd[:S]
    )


def run_em_sharded(
    gl,
    dist,
    state,
    opts: EMOptions,
    mesh_spec: dict,
    devices=None,
    log_callback=None,
    trace=None,
    checkpoint_cb=None,
    resume_bookkeeping=None,
    S_true=None,
    gather_final=True,
):
    """Full sharded training run: EM to convergence + Viterbi decode.

    gl [S, N, 3], dist [S] host/JAX arrays; state: EMState (n_rep == 1)
    or an EMState with a leading [R] replicate axis (the multi-restart
    protocol; mesh_spec["restart"] must divide R).  Returns EMResult, or
    RestartResult when state carries a replicate axis.

    The callbacks follow models/em.run_em; checkpoint/log/trace payloads
    see an UNPADDED gathered host view of the state. For n_rep == 1 it is
    a LAZY per-field view (_HostStateView: attribute access + iteration,
    not a pytree; fields gather on first touch) so callbacks that only
    read freq/indF/alpha never pay the [S, N]-sized gathers; restart-mode
    callbacks get an eager EMState. Checkpoints interoperate with the
    single-device engine (same io/checkpoint.py schema).

    gather_final=False (n_rep == 1 only) keeps the [S, N]-sized results
    DEVICE-resident: the returned state's e_prob/p_ibd and the Viterbi
    path stay as padded sharded jax.Arrays (small fields are gathered
    and unpadded as usual). At the BASELINE scale configs (1000 x 10M+)
    gathering those onto every host is tens of GB; callers stream
    windows out with distributed.fetch_chunk instead (the CLI's chunked
    final writers). Checkpoint/log callbacks still see gathered state.
    """
    r, i, s = mesh_spec["restart"], mesh_spec["ind"], mesh_spec["site"]
    S, N = int(gl.shape[-3]), int(gl.shape[-2])
    with_restart = state.indF.ndim == 2
    R = int(state.indF.shape[0]) if with_restart else None

    if devices is None:
        devices = jax.devices()
    n_dev = r * i * s
    if n_dev > len(devices):
        raise ValueError(
            f"mesh {r}x{i}x{s} needs {n_dev} devices, have {len(devices)}"
        )
    devices = list(devices)[:n_dev]
    if N % i != 0:
        raise ValueError(
            f"n_ind {N} not divisible by mesh ind axis {i} (individuals "
            "cannot be padded: they would perturb the est_maf reduction)"
        )
    if with_restart and R % r != 0:
        raise ValueError(
            f"--n_rep {R} not divisible by mesh restart axis {r}"
        )
    if not with_restart and r > 1:
        raise ValueError("mesh restart axis > 1 requires --n_rep > 1")
    if with_restart and s > 1:
        raise ValueError(
            "site mesh does not compose with --n_rep (replicated "
            "site-sharded chains are not implemented); run sequential "
            "restarts through the streaming engine (--stream_chunk N "
            "--n_rep R) or as separate seed-offset jobs"
        )
    if with_restart and not gather_final:
        raise ValueError(
            "gather_final=False is for n_rep == 1 runs (restart "
            "selection needs the gathered replicate axis)"
        )
    if opts.freq_est == 2 or opts.e_prob_calc == 2:
        raise NotImplementedError(
            "the LD path (freq_est/e_prob 2) is not implemented on "
            "meshes; use the single-chip engine"
        )
    # Multi-process runs (jax.distributed) arrive with inputs already
    # assembled as global arrays from per-host slabs
    # (parallel/distributed.global_from_slab). Site-sharded global inputs
    # arrive ALREADY padded to a shard multiple (the per-host loaders pad
    # their own slab); S_true carries the unpadded site count then.
    presharded = isinstance(gl, jax.Array) and not gl.is_fully_addressable

    # warm-started (F, alpha) M-step: the L-BFGS curvature memory is
    # threaded through the sharded step (models/em.py warm start),
    # checkpointed via the bookkeeping "opt_mem" key, and restored on
    # resume. A zeros memory IS the cold start, so the step always
    # threads an explicit tuple (one trace).
    warm = opts.warm_mstep and not (opts.indF_fixed and opts.alpha_fixed)

    if presharded and s > 1:
        S_pad = S
        S = S_true if S_true is not None else S
    else:
        S_pad = -(-S // s) * s  # site axis pads to a shard multiple
    compat = opts.viterbi_compat

    if s == 1:
        mesh = gl.sharding.mesh if presharded \
            else make_mesh(r, i, devices=devices)
        step_fn = make_sharded_em_step(
            mesh,
            freq_est=opts.freq_est,
            e_prob_calc=opts.e_prob_calc,
            indF_fixed=opts.indF_fixed,
            alpha_fixed=opts.alpha_fixed,
            with_restart=with_restart,
            block_size=opts.block_size,
            numerics=opts.numerics,
            warm=warm,
        )
        vit_fn = make_sharded_viterbi(
            mesh, compat=compat, with_restart=with_restart
        )
        if presharded:
            gl_d, dist_d, state_d = gl, dist, state
        else:
            gl_d, dist_d, state_d = shard_inputs(
                mesh, gl, dist, state, with_restart=with_restart
            )
    else:
        wdt = _work_dtype_for(opts)
        S_total = S if S_pad != S else None
        if not presharded:
            gl, dist, state = _pad_sites(gl, dist, state, S_pad)
        if i == 1:
            mesh = gl.sharding.mesh if presharded \
                else make_site_mesh(s, devices=devices)
            step_fn = make_site_sharded_em_step(
                mesh,
                freq_est=opts.freq_est,
                e_prob_calc=opts.e_prob_calc,
                indF_fixed=opts.indF_fixed,
                alpha_fixed=opts.alpha_fixed,
                work_dtype=wdt,
                S_total=S_total,
                warm=warm,
            )
            vit_fn = make_site_sharded_viterbi(mesh, compat=compat)
            if presharded:
                gl_d, dist_d, state_d = gl, dist, state
            else:
                gl_d, dist_d, state_d = shard_site_inputs(
                    mesh, gl, dist, state
                )
        else:
            mesh = gl.sharding.mesh if presharded \
                else make_grid_mesh(i, s, devices=devices)
            step_fn = make_grid_sharded_em_step(
                mesh,
                freq_est=opts.freq_est,
                e_prob_calc=opts.e_prob_calc,
                indF_fixed=opts.indF_fixed,
                alpha_fixed=opts.alpha_fixed,
                work_dtype=wdt,
                S_total=S_total,
                warm=warm,
            )
            vit_fn = make_grid_sharded_viterbi(mesh, compat=compat)
            if presharded:
                gl_d, dist_d, state_d = gl, dist, state
            else:
                gl_d, dist_d, state_d = shard_grid_inputs(
                    mesh, gl, dist, state
                )

    opt_holder = {"mem": None}
    if warm:
        mdt = state_d.indF.dtype
        opt_holder["mem"] = zero_opt_memory(
            N, mdt, n_rep=R if with_restart else None
        )
        if resume_bookkeeping and "opt_mem" in resume_bookkeeping:
            resume_bookkeeping = dict(resume_bookkeeping)
            raw = resume_bookkeeping.pop("opt_mem")
            if np.asarray(raw[0]).shape == opt_holder["mem"][0].shape:
                opt_holder["mem"] = tuple(
                    np.asarray(x, d) for x, d in zip(
                        raw, (mdt, mdt, bool, np.int32)
                    )
                )

    def step(st, active):
        if warm:
            st2, stats, mem2 = step_fn(gl_d, dist_d, st, opt_holder["mem"])
            opt_holder["mem"] = mem2
        else:
            st2, stats = step_fn(gl_d, dist_d, st)
        return st2, host_array(st2.ind_lkl), host_array(stats.fwbw_maxdiff)

    def freeze(new_st, old_st, active):
        mask = jnp.asarray(active)

        def sel(new, old):
            m = mask.reshape((R,) + (1,) * (new.ndim - 1))
            return jnp.where(m, new, old)

        return jax.tree.map(sel, new_st, old_st)

    def adapt_state(st):
        """Gathered, unpadded host view for callbacks/results."""
        host = EMState(*(host_array(x) for x in st))
        if S_pad != S:
            host = EMState(
                freq=host.freq[..., :S],
                indF=host.indF,
                alpha=host.alpha,
                e_prob=host.e_prob[..., :S, :, :],
                p_ibd=host.p_ibd[..., :S, :],
                ind_lkl=host.ind_lkl,
            )
        return host

    class _HostStateView:
        """Lazy PER-FIELD gathered/unpadded view of the sharded state for
        callbacks. Raw device state can span non-addressable devices on
        multi-process meshes (np.asarray on it raises), but gathering
        e_prob/p_ibd every cadence just in case would tax runs that never
        read them -- the gather happens per attribute on first touch
        (trace handlers at verbose >= 4; params-only checkpoints read
        just freq/indF/alpha). Supports field attributes and iteration /
        tuple-unpacking (which gathers everything, like the old eager
        adapt_state); NOT a pytree -- jax.tree.map sees one leaf.
        Restart-mode callbacks that tree-map the state get the eager
        adapt_state instead. On multi-process meshes each first touch is
        a COLLECTIVE: handlers must touch fields in the same order on
        every process (the CLI handlers gate only disk writes by
        process id, never the field access)."""

        _FIELDS = frozenset(EMState._fields)

        def __init__(self, st):
            self._dev = st
            self._cache = {}

        def __getattr__(self, name):
            if name not in _HostStateView._FIELDS:
                raise AttributeError(name)
            c = self._cache
            if name not in c:
                x = host_array(getattr(self._dev, name))
                if S_pad != S:
                    if name == "freq":
                        x = x[..., :S]
                    elif name == "e_prob":
                        x = x[..., :S, :, :]
                    elif name == "p_ibd":
                        x = x[..., :S, :]
                c[name] = x
            return c[name]

        def __iter__(self):
            return (getattr(self, f) for f in EMState._fields)

    wrap = adapt_state if with_restart else _HostStateView
    cb = None
    if checkpoint_cb is not None:

        def cb(n_iter, st, bk):
            if warm:
                # gathered on EVERY process (host_array is a collective
                # on multi-process meshes); O(m * N) -- tiny
                bk = dict(bk)
                bk["opt_mem"] = tuple(
                    host_array(x) for x in opt_holder["mem"]
                )
            checkpoint_cb(n_iter, wrap(st), bk)
    lg = None
    if log_callback is not None:
        lg = lambda n_iter, st, tot: log_callback(n_iter, wrap(st), tot)

    tr = trace
    if trace is not None:
        def tr(event, **kw):
            if "state" in kw:
                kw["state"] = _HostStateView(kw["state"])
            trace(event, **kw)

    state_d, bk, _ = convergence_loop(
        step,
        state_d,
        opts,
        n_ind=N,
        n_rep=R,
        freeze=freeze if with_restart else None,
        log_callback=lg,
        trace=tr,
        checkpoint_cb=cb,
        resume_bookkeeping=resume_bookkeeping,
        track_history=not with_restart,
    )

    # ---- final sharded Viterbi decode (EM.cpp:110-116)
    path_d = vit_fn(state_d.e_prob, dist_d, state_d.indF, state_d.alpha)

    if not gather_final:
        final = EMState(
            freq=host_array(state_d.freq)[:S],
            indF=host_array(state_d.indF),
            alpha=host_array(state_d.alpha),
            e_prob=state_d.e_prob,  # device, padded
            p_ibd=state_d.p_ibd,  # device, padded
            ind_lkl=host_array(state_d.ind_lkl),
        )
        return EMResult(
            state=final,
            path=path_d,  # device, padded
            tot_lkl=float(bk.tot[0]),
            n_iters=bk.n_iter,
            converged=bk.n_iter < opts.max_iters,
            lkl_history=bk.history,
        )

    path = host_array(path_d)
    final = adapt_state(state_d)

    if with_restart:
        best_rep = int(np.argmax(bk.tot))
        best_state = EMState(*(x[best_rep] for x in final))
        best = EMResult(
            state=best_state,
            path=path[best_rep][:S],
            tot_lkl=float(bk.tot[best_rep]),
            n_iters=int(bk.iters_done[best_rep]),
            converged=bool(bk.iters_done[best_rep] < opts.max_iters),
            lkl_history=[],
        )
        return RestartResult(
            best=best,
            best_rep=best_rep,
            rep_lkl=bk.tot.copy(),
            rep_iters=bk.iters_done.copy(),
        )

    return EMResult(
        state=final,
        path=path[:S],
        tot_lkl=float(bk.tot[0]),
        n_iters=bk.n_iter,
        converged=bk.n_iter < opts.max_iters,
        lkl_history=bk.history,
    )
