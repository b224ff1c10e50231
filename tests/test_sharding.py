"""Multi-device sharding: N-device mesh result must equal the 1-device
result (the analogue of the reference's thread-count invariance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parfastaai_jax.ops.fused import fused_aji
from parfastaai_jax.parallel.mesh import make_mesh, sharded_fused_aji


def _rand_presence(P=8, G=32, K=256, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    m = (rng.random((P, G, K)) < density).astype(np.uint8)
    t = m.sum(axis=2, dtype=np.int32)
    return m, t


@pytest.mark.parametrize("n_rows,n_scp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_mesh_matches_single_device(n_rows, n_scp):
    assert jax.device_count() >= n_rows * n_scp
    m, t = _rand_presence()
    mesh = make_mesh(n_rows, n_scp)
    aji, s, n = sharded_fused_aji(mesh, m, t)
    ref_aji, ref_s, ref_n = fused_aji(jnp.asarray(m), jnp.asarray(t))
    np.testing.assert_array_equal(np.asarray(n), np.asarray(ref_n))
    np.testing.assert_allclose(np.asarray(s), np.asarray(ref_s), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(aji), np.asarray(ref_aji), rtol=1e-5)


def test_mesh_shape_validation():
    mesh = make_mesh(8, 1)
    m, t = _rand_presence(G=30)  # 30 not divisible by 8 rows
    with pytest.raises(ValueError):
        sharded_fused_aji(mesh, m, t)


def test_make_mesh_too_many_devices():
    with pytest.raises(ValueError):
        make_mesh(16, 2)


def test_sharded_fused_sn_matches_aji_variant():
    """The sn-only entry (engine.compute_sharded's path, which discards
    aji) must agree exactly with sharded_fused_aji's (s, n) outputs."""
    m, t = _rand_presence(seed=3)
    mesh = make_mesh(4, 2)
    from parfastaai_jax.parallel.mesh import sharded_fused_sn

    s, n = sharded_fused_sn(mesh, m, t)
    _, ref_s, ref_n = sharded_fused_aji(mesh, m, t)
    np.testing.assert_array_equal(np.asarray(n), np.asarray(ref_n))
    np.testing.assert_array_equal(np.asarray(s), np.asarray(ref_s))
