"""Distribution base class — pytree-registered, jit/vmap/shard-friendly.

Blueprint: SURVEY.md C1 (distributions library: sample / log_prob /
reparameterized sampling / support metadata), the numerics layer every
inference backend sits on (BASELINE.json north_star "vectorized joint
log-prob evaluation", "reparameterized ELBO estimators").

Design decisions:
* Every distribution is a pytree (params are leaves) so instances can cross
  ``jit`` boundaries, live in ``lax.scan`` carries, and be ``vmap``-ed.
* ``sample`` takes an explicit PRNG key (functional, splittable per logical
  index — SURVEY.md §7 hard-part 3: PRNG discipline across shards).
* All densities are elementwise-vectorized jnp so XLA fuses them into the
  surrounding log-joint computation; no host control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from . import constraints

__all__ = ["Distribution", "Independent", "Delta", "TransformedDistribution"]


class Distribution:
    """Base class.

    Subclasses declare ``_params`` — attribute names that are pytree leaves —
    and ``_param_event_ndims`` (rightmost dims of each param that belong to a
    single event, used by :meth:`expand`).  Everything else in ``__dict__`` is
    static aux data (must be hashable).
    """

    _params: tuple = ()
    _param_event_ndims: dict = {}
    reparametrized: bool = True
    support = constraints.real

    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        jax.tree_util.register_pytree_node(
            cls, cls._tree_flatten, cls._tree_unflatten
        )

    def _tree_flatten(self):
        children = tuple(getattr(self, n) for n in self._params)
        aux = tuple(
            (k, v) for k, v in sorted(self.__dict__.items())
            if k not in self._params
        )
        return children, aux

    @classmethod
    def _tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        for name, child in zip(cls._params, children):
            object.__setattr__(obj, name, child)
        for k, v in aux:
            object.__setattr__(obj, k, v)
        return obj

    # -- shapes ------------------------------------------------------------
    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    @property
    def event_ndim(self):
        return len(self._event_shape)

    def shape(self, sample_shape=()):
        return tuple(sample_shape) + self._batch_shape + self._event_shape

    # -- core API ----------------------------------------------------------
    def sample(self, key, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, x):
        raise NotImplementedError

    def sample_and_log_prob(self, key, sample_shape=()):
        x = self.sample(key, sample_shape)
        return x, self.log_prob(x)

    @property
    def mean(self):
        raise NotImplementedError

    @property
    def variance(self):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    # -- structure helpers -------------------------------------------------
    def expand(self, batch_shape):
        """Broadcast this distribution's batch shape to ``batch_shape``.

        Union semantics: the result batch shape is
        ``broadcast_shapes(self.batch_shape, batch_shape)``, so extra leading
        axes already present (e.g. enumeration axes injected by the log-joint
        compiler, SURVEY.md C4) survive an ``expand`` written for the natural
        model shape."""
        batch_shape = lax.broadcast_shapes(self.batch_shape,
                                           tuple(batch_shape))
        new = object.__new__(type(self))
        for k, v in self.__dict__.items():
            object.__setattr__(new, k, v)
        for name in self._params:
            leaf = getattr(self, name)
            if leaf is None:
                continue             # optional bound (e.g. Censored.upper)
            if isinstance(leaf, Distribution):
                # wrapper distributions (Censored/Truncated/ZeroInflated/
                # TransformedDistribution) expand their base recursively;
                # wrappers with a non-batch-aligned base (Independent,
                # MixtureSameFamily, HMM) override expand instead
                object.__setattr__(new, name, leaf.expand(batch_shape))
                continue
            ev = self._param_event_ndims.get(name, 0)
            tail = jnp.shape(leaf)[len(jnp.shape(leaf)) - ev:] if ev else ()
            object.__setattr__(
                new, name, jnp.broadcast_to(leaf, batch_shape + tuple(tail))
            )
        object.__setattr__(new, "_batch_shape", batch_shape)
        return new

    def to_event(self, ndims=None):
        """Reinterpret the rightmost ``ndims`` batch dims as event dims."""
        if ndims is None:
            ndims = len(self.batch_shape)
        if ndims == 0:
            return self
        return Independent(self, ndims)

    def __repr__(self):
        return (
            f"{type(self).__name__}(batch_shape={self.batch_shape}, "
            f"event_shape={self.event_shape})"
        )


def _broadcast_shapes(*shapes):
    return lax.broadcast_shapes(*shapes)


class Independent(Distribution):
    """Reinterpret the rightmost ``ndims`` batch dims of ``base`` as event
    dims: ``log_prob`` sums over them."""

    _params = ("base_dist",)

    def __init__(self, base_dist, ndims):
        assert ndims <= len(base_dist.batch_shape)
        self.base_dist = base_dist
        self.ndims = ndims
        shape = base_dist.batch_shape
        split = len(shape) - ndims
        super().__init__(shape[:split], shape[split:] + base_dist.event_shape)

    @property
    def reparametrized(self):
        return self.base_dist.reparametrized

    @property
    def support(self):
        return self.base_dist.support

    def sample(self, key, sample_shape=()):
        return self.base_dist.sample(key, sample_shape)

    def log_prob(self, x):
        lp = self.base_dist.log_prob(x)
        return jnp.sum(lp, axis=tuple(range(-self.ndims, 0)))

    @property
    def mean(self):
        return self.base_dist.mean

    @property
    def variance(self):
        return self.base_dist.variance

    def entropy(self):
        return jnp.sum(
            self.base_dist.entropy(), axis=tuple(range(-self.ndims, 0))
        )

    def expand(self, batch_shape):
        batch_shape = tuple(batch_shape)
        event_batch = self.base_dist.batch_shape[
            len(self.base_dist.batch_shape) - self.ndims:
        ]
        return Independent(
            self.base_dist.expand(batch_shape + event_batch), self.ndims
        )


class Delta(Distribution):
    """Point mass — used for ``deterministic`` sites (SURVEY.md C3)."""

    _params = ("value",)

    def __init__(self, value, event_ndim=0):
        self.value = jnp.asarray(value)
        shape = self.value.shape
        split = len(shape) - event_ndim
        super().__init__(shape[:split], shape[split:])

    def sample(self, key, sample_shape=()):
        return jnp.broadcast_to(self.value, self.shape(sample_shape))

    def log_prob(self, x):
        lp = jnp.where(x == self.value, 0.0, -jnp.inf)
        if self.event_ndim:
            lp = jnp.sum(lp, axis=tuple(range(-self.event_ndim, 0)))
        return lp

    def expand(self, batch_shape):
        # base expand has no event-dim metadata for `value` (r2 review:
        # it broadcast to batch_shape alone and crashed for event_ndim>0)
        batch_shape = lax.broadcast_shapes(self.batch_shape,
                                           tuple(batch_shape))
        value = jnp.broadcast_to(self.value,
                                 batch_shape + self.event_shape)
        return Delta(value, event_ndim=len(self.event_shape))

    @property
    def mean(self):
        return self.value

    @property
    def variance(self):
        return jnp.zeros_like(self.value)


class TransformedDistribution(Distribution):
    """Pushforward of ``base`` through ``transform`` (forward direction).

    ``transform`` is a pytree child (transforms.py): array-parametrized
    transforms trace through jit, and stateless ones contribute only
    structurally-comparable aux — a freshly built instance per call does
    NOT retrace (tests/test_transforms.py::test_no_retrace_*)."""

    _params = ("base_dist", "transform")

    def __init__(self, base_dist, transform):
        self.base_dist = base_dist
        self.transform = transform
        base_event = base_dist.batch_shape + base_dist.event_shape
        out = transform.forward_shape(base_event)
        ev = max(
            transform.codomain_event_dim, len(base_dist.event_shape)
            + (len(out) - len(base_event))
        )
        split = len(out) - ev
        super().__init__(out[:split], out[split:])

    @property
    def reparametrized(self):
        return self.base_dist.reparametrized

    @property
    def support(self):
        """The transform's codomain when it declares one; else the base
        support (identity/affine-like transforms).  Without this, a
        transformed latent would be treated as unconstrained and NUTS/SVI
        could propose values outside the image (NaN density)."""
        cod = getattr(self.transform, "codomain", None)
        return cod if cod is not None else self.base_dist.support

    def sample(self, key, sample_shape=()):
        return self.transform.forward(self.base_dist.sample(key, sample_shape))

    def log_prob(self, x):
        u = self.transform.inverse(x)
        lp = self.base_dist.log_prob(u)
        ldj = self.transform.log_det_jacobian(u)
        # lp is reduced over the base's event dims, ldj over
        # transform.domain_event_dim; any leftover dims that became event dims
        # of *this* distribution still need summing before the subtraction.
        lp_extra = self.event_ndim - (
            len(self.base_dist.event_shape)
            + self.transform.codomain_event_dim
            - self.transform.domain_event_dim
        )
        if lp_extra > 0:
            lp = jnp.sum(lp, axis=tuple(range(-lp_extra, 0)))
        ldj_extra = self.event_ndim - self.transform.codomain_event_dim
        if ldj_extra > 0:
            ldj = jnp.sum(ldj, axis=tuple(range(-ldj_extra, 0)))
        return lp - ldj
