"""Multi-host (DCN) substrate: process init, host-sharded loading, gathers.

The reference is strictly single-host (one process, a pthread pool,
EM.cpp:151-159). Scaling past one host here follows SURVEY.md §5.8's
design: `jax.distributed` turns N processes x local chips into one
global device mesh; every process runs the SAME host program (the
convergence loop stays in lockstep because every control decision is
made from fully-replicated values); XLA inserts the cross-host
collectives (the est_maf psum over "ind" rides DCN).

Host-sharded loading: each process reads only its slab of the GL matrix
(io.readers.read_geno_slab -> native fseek/line-skip readers) and the
global array is assembled with `jax.make_array_from_process_local_data`
-- no host ever materialises the full [S, N, 3] matrix, which is what
makes the 5000 x 50M BASELINE config loadable at all.

Supported multi-process meshes: (restart, ind) -- the data-parallel
layout whose only collective is a psum (cheap over DCN) -- plus the
(site,) and (ind, site) grid layouts, whose boundary-carry all_gather
(a tiny P x N x 4-float exchange once per chain evaluation) also rides
DCN; each host loads its own (site, ind) rectangle of the GL matrix and
the site axis pads to a shard multiple on the last host's slab.

Validated by tests/test_distributed.py: 2 gloo-backed CPU processes x 4
virtual devices run the full CLI to convergence on the ind, site and
grid meshes and match the single-process engine on the same config.
"""

import numpy as np
import jax


def initialize(coordinator: str, num_processes: int, process_id: int):
    """Join (or start, for process 0) the distributed coordination
    service. On CPU backends the gloo collectives implementation is
    selected so cross-process psums work without an accelerator
    interconnect."""
    import jax._src.xla_bridge as xb  # backend must not be initialised yet

    if xb._backends:
        raise RuntimeError(
            "jax backend already initialised; --coordinator must be "
            "processed before any device use"
        )
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_distributed() -> bool:
    return jax.process_count() > 1


def axis_slab(sharding, global_shape, axis):
    """The contiguous [off, off+cnt) range of `axis` owned by this
    process's addressable devices under `sharding`.

    Raises if the local indices are not one contiguous range (would mean
    a device order that interleaves processes along the axis -- never
    the case for meshes built from jax.devices(), which is process-major).
    """
    idxmap = sharding.addressable_devices_indices_map(tuple(global_shape))
    n = global_shape[axis]
    ranges = sorted(
        {
            (sl[axis].start or 0,
             sl[axis].stop if sl[axis].stop is not None else n)
            for sl in idxmap.values()
        }
    )
    lo = ranges[0][0]
    hi = ranges[0][1]
    for a, b in ranges[1:]:
        if a > hi:
            raise ValueError(
                f"process-local indices along axis {axis} are not "
                f"contiguous: {ranges}"
            )
        hi = max(hi, b)
    return int(lo), int(hi - lo)


def global_from_slab(sharding, slab, global_shape):
    """Assemble a global jax.Array from this process's local slab
    (the block axis_slab says it owns, all other axes full)."""
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(slab), tuple(global_shape)
    )


def host_array(x):
    """A full host copy of a (possibly multi-process) jax.Array.

    Single-process / fully-addressable / fully-replicated arrays convert
    directly; cross-process sharded arrays are allgathered first (the
    convergence loop's control values and the final writers need full
    views on every process so the host programs stay in lockstep).
    """
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        if not x.is_fully_replicated:
            from jax.experimental import multihost_utils

            return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


_fetch_jits = {}  # (mesh, shape, dtype, axis, size) -> jitted slicer


def fetch_chunk(arr, axis, start, size):
    """Host copy of one [.., start:start+size, ..] window along `axis`.

    The scalable alternative to host_array for [S, N]-sized device
    arrays: instead of allgathering the whole array, one window is
    re-replicated on the array's mesh and pulled. For cross-process
    arrays this is a COLLECTIVE -- every process must call it in
    lockstep with the same arguments (only the writing process need use
    the result). Fully-addressable arrays (incl. single-process meshes
    and plain np/host arrays) take a direct slice, no collective.

    `start` is clamped like lax.dynamic_slice (the window shifts back to
    stay in bounds); callers iterate fixed-size windows and compensate
    with an in-window offset, as the CLI's .geno gather does.
    """
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    if not isinstance(arr, jax.Array):
        start = max(0, min(int(start), arr.shape[axis] - size))
        idx = tuple(
            slice(start, start + size) if a == axis else slice(None)
            for a in range(arr.ndim)
        )
        return np.asarray(arr[idx])

    # Every jax.Array goes through a cached jitted dynamic slice with a
    # TRACED start: an eager arr[start:stop] bakes the static start into
    # the program, compiling once per distinct window (thousands of
    # windows at BASELINE scale). One compile per (mesh, shape, axis,
    # size) instead.
    sh = arr.sharding
    mesh = sh.mesh if isinstance(sh, NamedSharding) else None
    key = (mesh, arr.shape, str(arr.dtype), axis, size)
    fn = _fetch_jits.get(key)
    if fn is None:
        def slicer(a, s0):
            return jax.lax.dynamic_slice_in_dim(a, s0, size, axis)

        if mesh is not None:
            fn = jax.jit(slicer, out_shardings=NamedSharding(mesh, P()))
        else:
            fn = jax.jit(slicer)
        _fetch_jits[key] = fn
    return np.asarray(fn(arr, start))


def local_slab(x, axis):
    """This process's contiguous block of a global array sharded along
    `axis` (all other axes unsharded), as one host np array.

    The inverse of global_from_slab for jit OUTPUTS: multi-host
    streaming keeps all host math per-individual, so each process pulls
    only its own ind columns from kernel results. No collective.
    """
    if not (isinstance(x, jax.Array) and not x.is_fully_addressable):
        return np.asarray(x)
    shards = sorted(
        x.addressable_shards, key=lambda s: s.index[axis].start or 0
    )
    seen = []
    parts = []
    for s in shards:
        key = (s.index[axis].start or 0)
        if key in seen:  # replicated over other mesh axes
            continue
        seen.append(key)
        parts.append(np.asarray(s.data))
    return np.concatenate(parts, axis=axis) if len(parts) > 1 else parts[0]
