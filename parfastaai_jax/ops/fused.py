"""Fused on-device AJI pipeline (production / benchmark path).

Computes, entirely on device with a single small result transfer:

    cnt_p = M_p @ M_p.T                (int8 x int8 -> int32, tensor cores)
    J_p   = cnt / (T_A + T_B - cnt)    (f32, masked cnt > 0)
    S     = sum_p J_p                  (f32)
    N     = sum_p [cnt_p > 0]          (int32)
    AJI   = S / N                      (f32; NaN when N == 0)

The protein axis is processed with ``lax.scan`` so HBM stays O(G^2 + P*G*K):
the (P, G, G) count tensor never materializes.  f32 accumulation over <= |P|
(~80) terms carries ~1e-7 relative error — fine for production AAI screening;
the CLI's default *exact* path (engine.compute) instead downloads integer
counts and finishes in f64 on host for bit-parity with the reference
(algorithm_impl.hpp:222-277 semantics either way).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _jaccard(cnt: jax.Array, denom: jax.Array) -> jax.Array:
    """Per-cell Jaccard term: cnt / denom where cnt > 0, else 0.  A select,
    not a clamped denominator: the two-database compat T-swap
    (modes.query_target) reads swapped T columns, so denom can fall to or
    below cnt where a genome lacks the protein, and the f32 paths must give
    what the exact path gives there."""
    return jnp.where(
        cnt > 0, cnt.astype(jnp.float32) / denom.astype(jnp.float32), 0.0
    )


@jax.jit
def fused_sn(m: jax.Array, t: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Full G x G fused (S, N) on one device — ``fused_aji`` without the
    final G x G divide.  The engine's accumulation paths (per-bucket sums)
    only ever need (s, n); materializing the discarded aji costs a G^2 f32
    divide + 4 G^2 bytes of HBM per call.

    Args:
      m: (P, G, K) int8/uint8 presence tensor (compacted tetramer axis).
      t: (P, G) int32 per-protein tetramer counts (rowsums of m).

    Returns (s f32 (G, G), n int32 (G, G)).
    """
    m8 = m.astype(jnp.int8)

    def step(carry, inputs):
        s, n = carry
        mp, tp = inputs  # (G, K) int8, (G,) int32
        cnt = jax.lax.dot_general(
            mp, mp, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
        )
        shared = cnt > 0
        j = _jaccard(cnt, tp[:, None] + tp[None, :] - cnt)
        return (s + j, n + shared.astype(jnp.int32)), None

    g = m.shape[1]
    init = (
        jnp.zeros((g, g), jnp.float32),
        jnp.zeros((g, g), jnp.int32),
    )
    (s, n), _ = jax.lax.scan(step, init, (m8, t))
    return s, n


@jax.jit
def fused_aji(m: jax.Array, t: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Full G x G fused AJI on one device.

    Args:
      m: (P, G, K) int8/uint8 presence tensor (compacted tetramer axis).
      t: (P, G) int32 per-protein tetramer counts (rowsums of m).

    Returns:
      (aji f32 (G, G), s f32 (G, G), n int32 (G, G)).  Diagonal entries are
      the genome's self-AJI (1.0); callers mask as needed.
    """
    s, n = fused_sn(m, t)
    aji = s / n.astype(jnp.float32)
    return aji, s, n


@partial(jax.jit, static_argnames=("vma_axes",))
def fused_sn_block(
    ma: jax.Array,
    mb: jax.Array,
    ta: jax.Array,
    tb: jax.Array,
    vma_axes: tuple[str, ...] = (),
) -> tuple[jax.Array, jax.Array]:
    """Rectangular fused (S, N) block: genomes-A band vs genomes-B band.

    ma: (P, A, K) int8, mb: (P, B, K) int8, ta: (P, A), tb: (P, B) int32.
    Returns (s f32 (A, B), n int32 (A, B)).  The building block of the
    streaming large-G scheduler (engine.compute_streamed) — each output band
    is O(A * B) while HBM holds only the two presence bands.

    ``vma_axes``: when called inside ``shard_map`` with inputs that vary over
    mesh axes, name those axes so the scan carry's varying-mesh-axes type
    matches (jax requires the initial carry to be pcast to varying).
    """

    def step(carry, inputs):
        s, n = carry
        mpa, mpb, tpa, tpb = inputs
        cnt = jax.lax.dot_general(
            mpa, mpb, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
        )
        shared = cnt > 0
        j = _jaccard(cnt, tpa[:, None] + tpb[None, :] - cnt)
        return (s + j, n + shared.astype(jnp.int32)), None

    a, b = ma.shape[1], mb.shape[1]
    init = (jnp.zeros((a, b), jnp.float32), jnp.zeros((a, b), jnp.int32))
    if vma_axes:
        init = jax.lax.pcast(init, vma_axes, to="varying")
    (s, n), _ = jax.lax.scan(
        step, init, (ma.astype(jnp.int8), mb.astype(jnp.int8), ta, tb)
    )
    return s, n


@partial(jax.jit, static_argnames=("out_dtype",))
def pair_counts_device(
    m: jax.Array,
    db_a: jax.Array,
    db_b: jax.Array,
    out_dtype: jnp.dtype = jnp.int32,
) -> jax.Array:
    """Exact intersection counts for an explicit pair list, gathered on device.

    Returns (P, n_pairs) in ``out_dtype`` — the only array the exact path
    transfers to host (counts fit int16 whenever max(T) < 2**15, halving the
    transfer).  Scans the protein axis; per step computes the G x G Gram
    matrix and gathers the requested (a, b) entries.
    """
    m8 = m.astype(jnp.int8)
    flat = db_a.astype(jnp.int32) * m.shape[1] + db_b.astype(jnp.int32)

    def step(_, mp):
        cnt = jax.lax.dot_general(
            mp, mp, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
        )
        return None, jnp.take(cnt.reshape(-1), flat).astype(out_dtype)

    _, out = jax.lax.scan(step, None, m8)
    return out
