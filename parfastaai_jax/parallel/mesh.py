"""Multi-device sharding of the fused AJI pipeline.

The reference's only parallelism is OpenMP threads over shared memory
(SURVEY §2.3); here it is an SPMD mesh with two axes:

* ``rows`` — data parallelism over genome row bands: each device owns a band
  of output rows (the pair-tile scheduler axis; replaces the reference's
  near-equal genome-pair split, algorithm_impl.hpp:100-120).
* ``scp``  — sharding of the protein axis: each device holds a slice of the
  presence tensor (for when P * G * K exceeds one device's memory) and
  partial (S, N) accumulators are reduced with ``psum`` (replaces the
  reference's shared-memory accumulation; there is nothing to sort or merge
  because counts are produced in place).

All collectives are XLA psums over the mesh, which XLA hands to NCCL on
GPUs.  The cards of one host are joined all to all, so the mesh shape
follows the algorithm alone.  Each device runs the same fused block as
the single-device engines (ops.fused.fused_sn_block).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.fused import fused_sn_block


def make_mesh(n_rows: int, n_scp: int = 1, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    n = n_rows * n_scp
    if len(devices) < n:
        raise ValueError(f"Need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(n_rows, n_scp)
    return Mesh(dev, axis_names=("rows", "scp"))


def _body(m_loc: jax.Array, t_loc: jax.Array, *, band: int,
          want_aji: bool = True):
    """Per-device program: local protein slice x full genome axis.

    m_loc: (P/scp, G, K) int8 — protein-sharded, genome-replicated.
    Computes this device's row band against all genomes, then psums the
    partial (S, N) over the protein shards.
    """
    r = jax.lax.axis_index("rows")
    ma = jax.lax.dynamic_slice_in_dim(m_loc, r * band, band, axis=1)
    ta = jax.lax.dynamic_slice_in_dim(t_loc, r * band, band, axis=1)
    s, n = fused_sn_block(ma, m_loc, ta, t_loc, vma_axes=("rows", "scp"))
    s = jax.lax.psum(s, "scp")
    n = jax.lax.psum(n, "scp")
    if not want_aji:
        return s, n
    aji = s / n.astype(jnp.float32)
    return aji, s, n


def _body_rect(ma_loc, mb_loc, ta_loc, tb_loc, *, band: int):
    """Per-device rectangular program: local protein slice, row band vs the
    full column side.  ta/tb are the *denominator* T values aligned to the
    rows of ma / mb (callers gather them through PairSpace's denom ids, so
    the two-database compat T-swap rides through unchanged)."""
    r = jax.lax.axis_index("rows")
    ma = jax.lax.dynamic_slice_in_dim(ma_loc, r * band, band, axis=1)
    ta = jax.lax.dynamic_slice_in_dim(ta_loc, r * band, band, axis=1)
    s, n = fused_sn_block(ma, mb_loc, ta, tb_loc, vma_axes=("rows", "scp"))
    return jax.lax.psum(s, "scp"), jax.lax.psum(n, "scp")


def sharded_fused_sn_rect(mesh: Mesh, ma, mb, ta, tb):
    """Rectangular fused (S, N) over a (rows, scp) mesh.

    The A side (genome rows) is banded over ``rows``; the protein axis is
    sharded over ``scp`` with a psum merge; the B side is replicated.

    Args:
      ma: (P, A, K) int8 presence rows; A divisible by mesh rows size,
          P by scp size (pad as needed — zero genomes/proteins are inert).
      mb: (P, B, K) int8 presence columns.
      ta: (P, A) int32 denominator T values for the rows.
      tb: (P, B) int32 denominator T values for the columns.

    Returns (s f32 (A, B), n int32 (A, B)), row-sharded over the mesh.
    """
    n_rows = mesh.shape["rows"]
    a = ma.shape[1]
    if a % n_rows or ma.shape[0] % mesh.shape["scp"]:
        raise ValueError(
            f"shape {ma.shape} not divisible by mesh {dict(mesh.shape)}"
        )
    band = a // n_rows
    fn = shard_map(
        partial(_body_rect, band=band),
        mesh=mesh,
        in_specs=(
            P("scp", None, None),
            P("scp", None, None),
            P("scp", None),
            P("scp", None),
        ),
        out_specs=(P("rows", None), P("rows", None)),
    )
    spec3 = NamedSharding(mesh, P("scp", None, None))
    spec2 = NamedSharding(mesh, P("scp", None))
    ma = jax.device_put(ma, spec3)
    mb = jax.device_put(mb, spec3)
    ta = jax.device_put(ta, spec2)
    tb = jax.device_put(tb, spec2)
    return jax.jit(fn)(ma, mb, ta, tb)


def _sharded_fused_square(mesh: Mesh, m, t, want_aji: bool):
    """Shared body of sharded_fused_aji / sharded_fused_sn: one validation,
    one shard_map spec set, one device_put path — the two public wrappers
    differ only in ``want_aji``."""
    n_rows = mesh.shape["rows"]
    g = m.shape[1]
    if g % n_rows or m.shape[0] % mesh.shape["scp"]:
        raise ValueError(
            f"shape {m.shape} not divisible by mesh {dict(mesh.shape)}"
        )
    band = g // n_rows
    fn = shard_map(
        partial(_body, band=band, want_aji=want_aji),
        mesh=mesh,
        in_specs=(P("scp", None, None), P("scp", None)),
        out_specs=(P("rows", None),) * (3 if want_aji else 2),
    )
    m = jax.device_put(m, NamedSharding(mesh, P("scp", None, None)))
    t = jax.device_put(t, NamedSharding(mesh, P("scp", None)))
    return jax.jit(fn)(m, t)


def sharded_fused_aji(mesh: Mesh, m, t):
    """Fused AJI over a (rows, scp) mesh.

    Args:
      m: (P, G, K) presence tensor; P divisible by mesh scp size, G by rows
         size (pad with zero genomes / empty proteins as needed).
      t: (P, G) int32.

    Returns (aji, s, n), each (G, G), row-sharded over the mesh.
    """
    return _sharded_fused_square(mesh, m, t, want_aji=True)


def sharded_fused_sn(mesh: Mesh, m, t):
    """``sharded_fused_aji`` without the final row-sharded G x G divide —
    for callers (engine.compute_fast mesh path) that only consume (s, n);
    the discarded aji otherwise costs a G^2/rows divide + 4 G^2 bytes of
    sharded HBM per call.  Same contract otherwise; returns (s, n)."""
    return _sharded_fused_square(mesh, m, t, want_aji=False)
