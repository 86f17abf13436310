"""Mesh construction and sharding plans — the only layer that names mesh
axes (SURVEY.md layer rule, §1b).

Blueprint: SURVEY.md C11 — the communication backend: there is no
hand-written one at all; distribution is expressed as ``jax.sharding.Mesh``
+ ``NamedSharding`` annotations and XLA compiles the collectives (NCCL on
GPUs).  Axis conventions:

  data      mini-batch shards for DP-SVI           (C12)
  chain     MCMC chains                            (C13a)
  particle  SMC particles                          (C13b)
  model     sharded latent blocks / obs dimension  (C13c/C13d)

Design rule (SURVEY.md §5): axes that only need scalar/small collectives
(data/chain/particle) go on the outer mesh dimension, which may span
hosts; ``model`` stays innermost so its heavier collectives stay within a
host's all-to-all NVLink.  Within one host every card reaches every other
at the same rate, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "P", "make_mesh", "shard_leading", "replicate", "put_replicated",
    "put_sharded", "local_slice", "AXES",
]

AXES = ("data", "chain", "particle", "model")


def make_mesh(axis_sizes: Optional[dict] = None, devices=None) -> Mesh:
    """Build a Mesh. ``axis_sizes`` maps axis name -> size; one axis may be
    -1 (absorbs remaining devices).  Default: all devices on ``"data"``."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if not axis_sizes:
        axis_sizes = {"data": n}
    names = tuple(axis_sizes)
    sizes = [axis_sizes[a] for a in names]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    dev_array = np.asarray(devices).reshape(sizes)
    return Mesh(dev_array, names)


def shard_leading(mesh: Mesh, axis: str) -> NamedSharding:
    """Sharding that splits the leading array dimension over ``axis``."""
    return NamedSharding(mesh, P(axis))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def put_sharded(tree, mesh: Mesh, axis: str):
    """device_put every leaf with its leading dim sharded over ``axis``."""
    s = shard_leading(mesh, axis)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), tree)


def put_replicated(tree, mesh: Mesh):
    s = replicate(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), tree)


def local_slice(global_size: int, axis_size: int, axis_index: int):
    """(start, size) of this shard's slice of a dimension (host data
    loading, SURVEY.md C15: each host feeds only its shard)."""
    assert global_size % axis_size == 0, (
        f"size {global_size} not divisible by mesh axis {axis_size}"
    )
    per = global_size // axis_size
    return axis_index * per, per
