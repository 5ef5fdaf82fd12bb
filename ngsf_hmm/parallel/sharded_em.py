"""shard_map'd EM step: individuals data-parallel, restarts as a mesh axis.

The full training step runs as ONE SPMD program per iteration:

 - forward/backward/Viterbi/L-BFGS are local to each "ind" shard (each
   individual's chain is independent -- the reference's property that made
   its pthread pool race-free, SURVEY.md §3.6g, becomes zero-communication
   sharding);
 - the freq M-step psums its per-site expected-allele-count accumulators
   over the "ind" axis once per inner fixed-point pass (est_maf,
   ops/maf.py) -- the only collective, riding NVLink;
 - the "restart" axis carries independent replicates (ngsF-HMM.sh protocol)
   with no communication at all.
"""

from functools import partial

import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.em import EMState, IterStats, em_iteration, resolve_numerics
from ..models.hmm import viterbi
from .mesh import data_specs


def opt_memory_specs(with_restart: bool = False):
    """PartitionSpecs for the warm-started M-step's L-BFGS curvature
    memory (S [m, N, 2], Y, valid [m, N], head [N]; a leading [R]
    replicate axis in restart mode). The batch axis is the individual
    axis, so every field -- INCLUDING the per-row ring-buffer head,
    which differs across ind-shards because each shard's solve runs its
    own iteration count -- shards over "ind" like indF."""
    if with_restart:
        return (
            P("restart", None, "ind", None),
            P("restart", None, "ind", None),
            P("restart", None, "ind"),
            P("restart", "ind"),
        )
    return (
        P(None, "ind", None),
        P(None, "ind", None),
        P(None, "ind"),
        P("ind"),
    )


def zero_opt_memory(n_cols, dtype, n_rep=None):
    """A zeros curvature memory == the cold start (no valid pairs);
    threading it explicitly keeps the sharded step at ONE trace."""
    import jax.numpy as jnp

    from ..models.lbfgsb import MVAL

    lead = () if n_rep is None else (n_rep,)
    return (
        jnp.zeros(lead + (MVAL, n_cols, 2), dtype),
        jnp.zeros(lead + (MVAL, n_cols, 2), dtype),
        jnp.zeros(lead + (MVAL, n_cols), bool),
        jnp.zeros(lead + (n_cols,), jnp.int32),
    )


def make_sharded_em_step(
    mesh,
    freq_est=1,
    e_prob_calc=1,
    indF_fixed=False,
    alpha_fixed=False,
    with_restart=False,
    block_size=None,
    numerics="log",
    warm=False,
):
    """Returns a jitted sharded step: (gl, dist, state) -> (state', stats).

    Without restart: gl [S, N, 3], state fields as in models/em.py.
    With restart: every EMState field gains a leading [R] axis sharded over
    the "restart" mesh axis; gl stays [S, N, 3] (same data per replicate).
    block_size/numerics: kernel tier of the per-shard em_iteration
    ("log" sequential/blocked, "linear" blocked XLA kernels, "pallas"
    Triton chain kernels running shard-local under shard_map -- the
    freq M-step's XLA est_maf accumulators then psum over "ind").
    Replicate runs (with_restart) take the blocked-linear tier
    (models.em.resolve_numerics): the restart axis vmaps em_iteration.

    warm=True: the step becomes (gl, dist, state, opt_mem) ->
    (state', stats, opt_mem') threading the M-step's L-BFGS curvature
    memory across iterations (zero_opt_memory to start).
    """
    tier, _ = resolve_numerics(numerics, freq_est, e_prob_calc,
                               replicates=with_restart)
    if tier != numerics:
        numerics, block_size = tier, block_size or "auto"
    gl_spec, dist_spec, st = data_specs(with_restart)
    state_specs = EMState(**st)

    core = partial(
        em_iteration,
        freq_est=freq_est,
        e_prob_calc=e_prob_calc,
        indF_fixed=indF_fixed,
        alpha_fixed=alpha_fixed,
        axis_name="ind",
        block_size=block_size,
        numerics=numerics,
        return_opt=warm,
    )

    if with_restart:
        stats_spec = IterStats(P("restart"), P("restart"))

        if warm:

            def body(gl, dist, state, mem):
                return jax.vmap(
                    lambda s, m: core(gl, dist, s, opt_memory=m)
                )(state, mem)

        else:

            def body(gl, dist, state):
                return jax.vmap(
                    lambda s: core(gl, dist, s), in_axes=0, out_axes=0
                )(state)

    else:
        stats_spec = IterStats(P(), P())

        if warm:

            def body(gl, dist, state, mem):
                return core(gl, dist, state, opt_memory=mem)

        else:

            def body(gl, dist, state):
                return core(gl, dist, state)

    mem_specs = opt_memory_specs(with_restart)
    in_specs = (gl_spec, dist_spec, state_specs)
    out_specs = (state_specs, stats_spec)
    if warm:
        in_specs = in_specs + (mem_specs,)
        out_specs = out_specs + (mem_specs,)
    step = shard_map(
        body,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(step)


def make_sharded_viterbi(mesh, compat=True, with_restart=False):
    """Sharded final decode: path [.., S, N] int8."""
    gl_spec, dist_spec, st = data_specs(with_restart)

    def one(e_prob, dist, F, alpha):
        return viterbi(e_prob, dist, F, alpha, compat=compat)[0]

    if with_restart:
        body = lambda e, d, F, a: jax.vmap(lambda ee, FF, aa: one(ee, d, FF, aa))(e, F, a)
        out_spec = P("restart", None, "ind")
    else:
        body = one
        out_spec = P(None, "ind")

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(st["e_prob"], dist_spec, st["indF"], st["alpha"]),
        out_specs=out_spec,
        check_vma=False,
    )
    return jax.jit(fn)


def shard_inputs(mesh, gl, dist, state, with_restart=False):
    """Place host arrays onto the mesh with the canonical shardings."""
    gl_spec, dist_spec, st = data_specs(with_restart)
    dev = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    gl = dev(gl, gl_spec)
    dist = dev(dist, dist_spec)
    state = EMState(*(dev(x, st[f]) for f, x in zip(EMState._fields, state)))
    return gl, dist, state
