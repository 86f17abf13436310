"""Finite mixtures with the components' batch axis as mixture axis.

Blueprint: SURVEY.md C1 ("Mixture") — backs the GMM example (configs[3],
SURVEY.md C19) with the assignment variable marginalised out, which is the
accelerator-friendly formulation (dense logsumexp over components; no discrete latent
sites in the kernel hot loop).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from .discrete import Categorical
from .distribution import Distribution

__all__ = ["MixtureSameFamily"]


class MixtureSameFamily(Distribution):
    """``mixing`` is a Categorical over K; ``components`` is a distribution
    whose rightmost *batch* dim is K (one slice per component)."""

    _params = ("mixing", "components")

    def __init__(self, mixing, components):
        if not isinstance(mixing, Categorical):
            raise TypeError("mixing must be a Categorical")
        k = components.batch_shape[-1]
        if mixing.num_categories != k:
            raise ValueError(
                f"mixing has {mixing.num_categories} categories but "
                f"components' mixture axis is {k}"
            )
        self.mixing = mixing
        self.components = components
        batch = jax.lax.broadcast_shapes(
            mixing.batch_shape, components.batch_shape[:-1]
        )
        super().__init__(batch, components.event_shape)

    @property
    def num_components(self):
        return self.components.batch_shape[-1]

    @property
    def support(self):
        return self.components.support

    reparametrized = False  # discrete index breaks the pathwise gradient

    def log_prob(self, x):
        ev = len(self.components.event_shape)
        x_exp = jnp.expand_dims(x, axis=-1 - ev)  # add mixture axis
        comp_lp = self.components.log_prob(x_exp)  # (..., K)
        mix_lp = self.mixing.log_probs_normalized()
        return logsumexp(mix_lp + comp_lp, axis=-1)

    def sample(self, key, sample_shape=()):
        key_idx, key_comp = jax.random.split(key)
        idx = self.mixing.sample(key_idx, sample_shape)  # (..., batch)
        comps = self.components.sample(key_comp, sample_shape)
        # comps: (..., batch, K, event); select along the mixture axis.
        ev = len(self.components.event_shape)
        idx_exp = idx.reshape(idx.shape + (1,) * (1 + ev))
        axis = -1 - ev
        return jnp.take_along_axis(comps, idx_exp, axis=axis).squeeze(axis)

    @property
    def mean(self):
        ev = len(self.components.event_shape)
        w = self.mixing.probs
        w = w.reshape(w.shape + (1,) * ev)
        return jnp.sum(w * self.components.mean, axis=-1 - ev)

    def expand(self, batch_shape):
        batch_shape = tuple(batch_shape)
        return MixtureSameFamily(
            self.mixing.expand(batch_shape),
            self.components.expand(batch_shape + (self.num_components,)),
        )
