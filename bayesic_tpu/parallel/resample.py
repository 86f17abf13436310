"""Systematic resampling — single-device and cross-shard.

Blueprint: SURVEY.md C13b, the hardest collective choreography (§7 hard-part
1): "a globally-ordered, low-variance resampler needs a cross-host prefix sum
and data-dependent cross-shard particle routing inside a jit".

Two interchangeable implementations (tested equal, SURVEY.md §4.5):

* :func:`systematic_ancestors` + gather under plain ``jit`` with sharded
  arrays — the idiomatic JAX path: XLA's SPMD partitioner turns the global
  cumsum/searchsorted/gather into the needed collectives automatically.
* :func:`systematic_resample_shard_map` — the explicit choreography from
  SURVEY.md §3.3: global weight normalization (psum), distributed prefix sum
  (compensated local cumsums + shard offsets), shard-local stratified
  positions, and payload routing.  Routing has two modes:

  - ``routing="ring"`` (default): P ``ppermute`` hops move one shard-sized
    chunk at a time around the ring; each shard copies out the rows whose
    (sorted, systematic) ancestors originate from the visiting chunk.  Peak
    payload memory is O(n_local · dim) per device — N-scalable (VERDICT r1
    item 4).  Total bytes moved equal the all_gather's, but never resident
    at once.
  - ``routing="all_gather"``: the round-1 dense recast — every shard
    gathers the full particle payload (O(N_global · dim) per device); kept
    for small populations and as the oracle.

Numerics (SURVEY.md §7 hard-part 4): all weight prefix sums use
:func:`compensated_cumsum` — blocked f32 cumsum with a Kahan-compensated
scan over block totals, so the absolute error is bounded by the block size,
not the population size; at 2^20 particles a plain f32 cumsum drifts past
the 1/N stratified-position spacing and systematic counts lose their
floor/ceil guarantee (tested in tests/test_sharding.py).

Both paths use ONE shared uniform u0 (from a key that must be identical on
every shard) so the sharded result matches the single-device result — the
SURVEY.md §4.5 golden rule.  On the CPU it is bit-identical.  On a GPU the
two prefix sums add in different orders, so a position within float32
rounding of a boundary may pick the neighbouring ancestor: each offspring
count still agrees within one.  Beyond 2^20 particles float32 no longer
resolves the 1/N spacing near a cumulative weight of 1, and the floor/ceil
guarantee is lost (an open defect, listed in ROADMAP.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import logsumexp

__all__ = [
    "normalize_log_weights", "effective_sample_size",
    "compensated_cumsum", "systematic_ancestors", "systematic_resample",
    "systematic_resample_shard_map",
]


def normalize_log_weights(log_weights):
    return log_weights - logsumexp(log_weights)


def effective_sample_size(log_weights):
    """ESS = (sum w)^2 / sum w^2 for unnormalized log weights."""
    lw = normalize_log_weights(log_weights)
    return jnp.exp(-logsumexp(2.0 * lw))


def _kahan_exclusive_cumsum(x):
    """Exclusive prefix sum with Kahan compensation: error O(eps), not
    O(n·eps).  Sequential scan — use only on short arrays (block totals,
    shard totals)."""

    def body(carry, s):
        total, comp = carry
        y = s - comp
        t = total + y
        comp = (t - total) - y
        return (t, comp), total

    # derive the zero from x so varying-manual-axes match under shard_map
    zero = x[0] * 0
    (_, _), out = lax.scan(body, (zero, zero), x)
    return out


def compensated_cumsum(x, block=1024):
    """Inclusive cumulative sum whose absolute error is bounded by the
    block size: within-block plain cumsum + Kahan-compensated block
    offsets.  For n <= block this is exactly ``jnp.cumsum``."""
    n = x.shape[0]
    if n <= block:
        return jnp.cumsum(x)
    pad = (-n) % block
    xb = jnp.pad(x, (0, pad)).reshape(-1, block)
    within = jnp.cumsum(xb, axis=1)
    offsets = _kahan_exclusive_cumsum(within[:, -1])
    return (within + offsets[:, None]).reshape(-1)[:n]


def systematic_ancestors(key, log_weights, num_out=None):
    """Global systematic resampling: ancestor indices of shape (num_out,).

    Positions u_j = (j + u0)/N with one shared uniform u0; ancestor_j is the
    index i with C_{i-1} <= u_j < C_i (C = normalized weight cumsum).
    """
    n = log_weights.shape[0]
    num_out = n if num_out is None else num_out
    w = jnp.exp(normalize_log_weights(log_weights))
    cum = compensated_cumsum(w)
    cum = cum / cum[-1]                      # exact 1.0 endpoint
    u0 = jax.random.uniform(key)
    pos = (jnp.arange(num_out) + u0) / num_out
    return jnp.clip(jnp.searchsorted(cum, pos, side="right"), 0, n - 1)


def systematic_resample(key, log_weights, particles, num_out=None):
    """Resample a particle pytree; works on sharded arrays under jit (XLA
    inserts the cross-shard gather)."""
    idx = systematic_ancestors(key, log_weights, num_out)
    return jax.tree_util.tree_map(lambda x: jnp.take(x, idx, axis=0),
                                  particles), idx


def _ring_route(particles_local, src_shard, src_row, axis_name):
    """Route resampled payloads around the ring: P ppermute hops, each shard
    keeping the rows whose ancestor lives in the currently visiting chunk.
    Peak memory O(n_local · dim); collective-symmetric (every shard performs
    the identical P hops regardless of where its ancestors live)."""
    p = lax.axis_size(axis_name)
    me = lax.axis_index(axis_name)
    perm = [(i, (i - 1) % p) for i in range(p)]

    out0 = jax.tree_util.tree_map(jnp.zeros_like, particles_local)

    def body(t, carry):
        chunk, out = carry
        origin = (me + t) % p
        mask = src_shard == origin

        def upd(o, c):
            rows = jnp.take(c, src_row, axis=0)
            m = mask.reshape(mask.shape + (1,) * (o.ndim - 1))
            return jnp.where(m, rows, o)

        out = jax.tree_util.tree_map(upd, out, chunk)
        chunk = jax.tree_util.tree_map(
            lambda c: lax.ppermute(c, axis_name, perm=perm), chunk
        )
        return chunk, out

    _, out = lax.fori_loop(0, p, body, (particles_local, out0))
    return out


def systematic_resample_shard_map(axis_name, routing="ring"):
    """Explicit SPMD resampler for use inside ``shard_map``.

    Returns ``fn(key, local_log_weights, local_particles) ->
    (local_particles_out, local_ancestors_global_idx)``.

    ``key`` must be identical across shards (it seeds the single shared
    stratified offset u0).  ``routing`` picks the payload movement:
    ``"ring"`` (O(n_local) peak memory, default) or ``"all_gather"``
    (O(N_global) peak memory — the round-1 dense recast, kept as oracle).
    """
    if routing not in ("ring", "all_gather"):
        raise ValueError(f"unknown routing {routing!r}")

    def fn(key, lw_local, particles_local):
        n_local = lw_local.shape[0]
        p = jax.lax.axis_size(axis_name)
        me = jax.lax.axis_index(axis_name)
        n_global = n_local * p

        # -- global normalization (collective #1: max + sum) --------------
        gmax = jax.lax.pmax(jnp.max(lw_local), axis_name)
        w_local = jnp.exp(lw_local - gmax)
        shard_sum = jnp.sum(w_local)
        total = jax.lax.psum(shard_sum, axis_name)
        w_local = w_local / total

        # -- distributed prefix sum (collective #2: all_gather of P sums;
        #    Kahan offsets + blocked-compensated local cumsum) -------------
        shard_sums = jax.lax.all_gather(shard_sum / total, axis_name)  # (P,)
        offset = _kahan_exclusive_cumsum(shard_sums)[me]
        local_cum = offset + compensated_cumsum(w_local)

        # -- shared stratified positions for MY output slots ---------------
        u0 = jax.random.uniform(key)
        out_start = me * n_local
        pos = (out_start + jnp.arange(n_local) + u0) / n_global

        # -- global ancestor indices: searchsorted over the gathered global
        # cumsum (O(N_global) *scalars* per device — 4 MB at 2^20; the
        # payload, which is O(N·dim), is what the routing modes bound)
        cum_global = jax.lax.all_gather(local_cum, axis_name).reshape(-1)
        cum_global = cum_global / cum_global[-1]   # exact 1.0 endpoint
        anc = jnp.clip(
            jnp.searchsorted(cum_global, pos, side="right"), 0, n_global - 1
        )

        if routing == "ring":
            out = _ring_route(
                particles_local, anc // n_local, anc % n_local, axis_name
            )
            return out, anc

        gathered = jax.tree_util.tree_map(
            lambda x: jax.lax.all_gather(x, axis_name).reshape(
                (n_global,) + x.shape[1:]
            ),
            particles_local,
        )
        out = jax.tree_util.tree_map(
            lambda x: jnp.take(x, anc, axis=0), gathered
        )
        return out, anc

    return fn
