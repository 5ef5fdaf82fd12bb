"""Sharded EM step vs single-device: identical results on an 8-CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oracle
from ngsf_hmm.models.em import EMState, em_iteration, init_state
from ngsf_hmm.parallel.mesh import make_mesh
from ngsf_hmm.parallel.sharded_em import (
    make_sharded_em_step,
    make_sharded_viterbi,
    shard_inputs,
)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    S, N = 64, 16
    gl = np.log(rng.dirichlet(np.ones(3), size=(S, N)))
    dist = rng.uniform(0.01, 0.3, size=S)
    dist[0] = 1.0
    freq0 = rng.uniform(0.05, 0.45, size=S)
    indF0 = rng.uniform(0.05, 0.9, size=N)
    alpha0 = rng.uniform(0.01, 0.5, size=N)
    gl_j = jnp.asarray(gl)
    state = init_state(gl_j, jnp.asarray(freq0), jnp.asarray(indF0), jnp.asarray(alpha0))
    return gl_j, jnp.asarray(dist), state


def _tree_allclose(a: EMState, b: EMState, atol):
    for f, x, y in zip(EMState._fields, a, b):
        np.testing.assert_allclose(
            np.asarray(x), np.asarray(y), atol=atol, err_msg=f
        )


def test_requires_8_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


def test_sharded_step_matches_single_device(case):
    gl, dist, state = case
    ref_state, ref_stats = em_iteration(gl, dist, state)

    mesh = make_mesh(n_restart=1, n_ind_shards=8)
    step = make_sharded_em_step(mesh)
    gl_s, dist_s, state_s = shard_inputs(mesh, gl, dist, state)
    out_state, out_stats = step(gl_s, dist_s, state_s)

    # freq is the psum-reduced quantity -- the true multi-chip consistency
    # test; everything else is local math on shards.
    _tree_allclose(out_state, ref_state, atol=1e-10)
    assert float(out_stats[0]) == pytest.approx(float(ref_stats[0]), abs=1e-9)


def test_sharded_step_pallas_tier_matches(case):
    """numerics="pallas" under the ind-sharded shard_map: the chain
    kernels run shard-local (interpret mode on CPU), the freq M-step
    psums its accumulators; must match the single-device pallas tier to
    f32 reduction-order roundoff."""
    gl, dist, state = case
    gl32 = gl.astype(jnp.float32)
    dist32 = dist.astype(jnp.float32)
    st32 = EMState(*(x.astype(jnp.float32) for x in state))
    ref_state, _ = em_iteration(
        gl32, dist32, st32, numerics="pallas", block_size="auto"
    )

    mesh = make_mesh(n_restart=1, n_ind_shards=8)
    step = make_sharded_em_step(mesh, numerics="pallas")
    gl_s, dist_s, state_s = shard_inputs(mesh, gl32, dist32, st32)
    out_state, _ = step(gl_s, dist_s, state_s)

    _tree_allclose(out_state, ref_state, atol=5e-6)


def test_sharded_viterbi_matches(case):
    gl, dist, state = case
    state1, _ = em_iteration(gl, dist, state)
    from ngsf_hmm.models.hmm import viterbi

    want, _ = viterbi(state1.e_prob, dist, state1.indF, state1.alpha)

    mesh = make_mesh(n_restart=1, n_ind_shards=8)
    vit = make_sharded_viterbi(mesh)
    gl_s, dist_s, state_s = shard_inputs(mesh, gl, dist, state1)
    got = vit(state_s.e_prob, dist_s, state_s.indF, state_s.alpha)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_restart_axis(case):
    """(restart=2, ind=4) mesh: replicates evolve independently and match
    their single-device counterparts."""
    gl, dist, state = case
    R = 2
    # two different inits along the restart axis
    state_r = EMState(
        freq=jnp.stack([state.freq, state.freq * 0.5]),
        indF=jnp.stack([state.indF, jnp.clip(state.indF * 0.3, 1e-6, 1)]),
        alpha=jnp.stack([state.alpha, state.alpha * 2.0]),
        e_prob=jnp.stack([state.e_prob, state.e_prob]),
        p_ibd=jnp.stack([state.p_ibd, state.p_ibd]),
        ind_lkl=jnp.stack([state.ind_lkl, state.ind_lkl]),
    )
    # fix the replicate-1 emission to its own freq for a fair comparison
    from ngsf_hmm.ops.emissions import calc_emission

    e1 = calc_emission(gl, (state.freq * 0.5)[:, None])
    state_r = state_r._replace(e_prob=state_r.e_prob.at[1].set(e1))

    mesh = make_mesh(n_restart=R, n_ind_shards=4)
    step = make_sharded_em_step(mesh, with_restart=True)
    gl_s, dist_s, state_s = shard_inputs(mesh, gl, dist, state_r, with_restart=True)
    out, stats = step(gl_s, dist_s, state_s)

    for r in range(R):
        single = EMState(*(x[r] for x in state_r))
        want, _ = em_iteration(gl, dist, single)
        got = EMState(*(np.asarray(x)[r] for x in out))
        _tree_allclose(got, want, atol=1e-10)
