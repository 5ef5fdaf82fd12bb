"""Site-dimension sharding (parallel/site_sharded.py) on a virtual
8-device CPU mesh vs the single-device linear EM step.

The cross-shard state is only each shard's 2x2 transfer product; full EM
trajectories (posteriors, freq, (F, alpha), likelihoods) must match the
unsharded engine to f32 kernel tolerances."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ngsf_hmm.models.em import em_iteration, init_state
from ngsf_hmm.parallel.site_sharded import (
    make_site_mesh,
    make_site_sharded_em_step,
    shard_site_inputs,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    S, N = 1600, 6  # 8 shards x 200 sites
    raw = rng.random((S, N, 3)) + 1e-3
    gl = jnp.asarray(np.log(raw / raw.sum(-1, keepdims=True)), jnp.float32)
    dist = np.abs(rng.random(S)) * 0.05
    dist[0] = 0.7
    dist[700] = np.inf  # chromosome break inside shard 3
    dist = jnp.asarray(dist, jnp.float32)
    state = init_state(
        gl,
        jnp.full((S,), 0.2, jnp.float32),
        jnp.asarray(rng.uniform(0.1, 0.6, N), jnp.float32),
        jnp.asarray(rng.uniform(0.02, 0.2, N), jnp.float32),
    )
    return gl, dist, state


def test_site_sharded_em_matches_single_device(data):
    gl, dist, state0 = data
    mesh = make_site_mesh(8)
    step = make_site_sharded_em_step(mesh)
    gl_d, dist_d, st_d = shard_site_inputs(mesh, gl, dist, state0)

    st_ref = state0
    for _ in range(3):
        st_d, stats = step(gl_d, dist_d, st_d)
        st_ref, _ = em_iteration(
            gl, dist, st_ref, block_size="auto", numerics="linear"
        )
        assert float(stats.fwbw_maxdiff) < 1e-2

    np.testing.assert_allclose(
        np.asarray(st_d.ind_lkl), np.asarray(st_ref.ind_lkl), rtol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(st_d.indF), np.asarray(st_ref.indF), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(st_d.alpha), np.asarray(st_ref.alpha), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(st_d.freq), np.asarray(st_ref.freq), atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(st_d.p_ibd), np.asarray(st_ref.p_ibd), atol=5e-3
    )
    # replicated params must be bitwise identical across shards
    shards = [np.asarray(s.data) for s in st_d.indF.addressable_shards]
    for sh in shards[1:]:
        np.testing.assert_array_equal(sh, shards[0])


def test_site_sharded_uneven_would_fail_loudly(data):
    """Shard counts must divide S (no silent padding across devices)."""
    gl, dist, state0 = data
    mesh = make_site_mesh(8)
    step = make_site_sharded_em_step(mesh)
    bad_gl = gl[:1500]
    with pytest.raises(Exception):
        gl_d, dist_d, st_d = shard_site_inputs(
            mesh, bad_gl, dist[:1500],
            jax.tree.map(
                lambda x: x[:1500] if x.shape and x.shape[0] == 1600 else x,
                state0,
            ),
        )
        jax.block_until_ready(step(gl_d, dist_d, st_d))


@pytest.mark.parametrize("compat", [True, False])
def test_site_sharded_viterbi_matches(data, compat):
    """The max-plus boundary-state decomposition must reproduce the
    monolithic Viterbi path exactly (both the compat in-place variant
    and the textbook one)."""
    from ngsf_hmm.models.hmm import viterbi
    from ngsf_hmm.parallel.site_sharded import make_site_sharded_viterbi
    from jax.sharding import NamedSharding, PartitionSpec as P

    gl, dist, state0 = data
    mesh = make_site_mesh(8)
    step = make_site_sharded_em_step(mesh)
    gl_d, dist_d, st_d = shard_site_inputs(mesh, gl, dist, state0)
    st_d, _ = step(gl_d, dist_d, st_d)  # realistic params/emissions

    e_prob = jnp.asarray(np.asarray(st_d.e_prob))
    F = jnp.asarray(np.asarray(st_d.indF))
    alpha = jnp.asarray(np.asarray(st_d.alpha))

    want, _ = viterbi(e_prob, jnp.asarray(dist), F, alpha, compat=compat)

    vit = make_site_sharded_viterbi(mesh, compat=compat)
    dev = lambda x, s: jax.device_put(x, NamedSharding(mesh, s))
    got = vit(
        dev(e_prob, P("site", None, None)), dev(jnp.asarray(dist), P("site")),
        dev(F, P()), dev(alpha, P()),
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_grid_mesh_2d_matches_single_device(data):
    """Composed (ind, site) 2-D mesh (2 ind-shards x 4 site-shards):
    full EM trajectories must match the single-device linear engine."""
    from ngsf_hmm.parallel.site_sharded import (
        make_grid_mesh,
        make_grid_sharded_em_step,
        shard_grid_inputs,
    )

    gl, dist, state0 = data  # N = 6 -> 3 individuals per ind-shard
    mesh = make_grid_mesh(2, 4)
    step = make_grid_sharded_em_step(mesh)
    gl_d, dist_d, st_d = shard_grid_inputs(mesh, gl, dist, state0)

    st_ref = state0
    for _ in range(3):
        st_d, stats = step(gl_d, dist_d, st_d)
        st_ref, _ = em_iteration(
            gl, dist, st_ref, block_size="auto", numerics="linear"
        )

    np.testing.assert_allclose(
        np.asarray(st_d.ind_lkl), np.asarray(st_ref.ind_lkl), rtol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(st_d.indF), np.asarray(st_ref.indF), atol=5e-4
    )
    np.testing.assert_allclose(
        np.asarray(st_d.freq), np.asarray(st_ref.freq), atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(st_d.p_ibd), np.asarray(st_ref.p_ibd), atol=5e-3
    )


@pytest.mark.parametrize("compat", [True, False])
def test_grid_sharded_viterbi_matches(data, compat):
    """Decode on the 2-D (ind, site) grid reproduces the monolithic
    Viterbi path exactly."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ngsf_hmm.models.hmm import viterbi
    from ngsf_hmm.parallel.site_sharded import (
        make_grid_mesh,
        make_grid_sharded_em_step,
        make_grid_sharded_viterbi,
        shard_grid_inputs,
    )

    gl, dist, state0 = data
    mesh = make_grid_mesh(2, 4)
    step = make_grid_sharded_em_step(mesh)
    gl_d, dist_d, st_d = shard_grid_inputs(mesh, gl, dist, state0)
    st_d, _ = step(gl_d, dist_d, st_d)  # realistic params/emissions

    e_prob = jnp.asarray(np.asarray(st_d.e_prob))
    F = jnp.asarray(np.asarray(st_d.indF))
    alpha = jnp.asarray(np.asarray(st_d.alpha))
    want, _ = viterbi(e_prob, jnp.asarray(dist), F, alpha, compat=compat)

    vit = make_grid_sharded_viterbi(mesh, compat=compat)
    dev = lambda x, s: jax.device_put(x, NamedSharding(mesh, s))
    got = vit(
        dev(e_prob, P("site", "ind", None)),
        dev(jnp.asarray(dist), P("site")),
        dev(F, P("ind")), dev(alpha, P("ind")),
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
