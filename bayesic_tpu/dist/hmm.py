"""Hidden Markov model distribution — marginal likelihood via the forward
algorithm, as one ``lax.scan`` of dense (K, K) state updates.

Blueprint: SURVEY.md C1/C4 — the chain-structured counterpart of
``MixtureSameFamily``: the discrete state path is marginalised *inside*
``log_prob`` (TFP-style ``HiddenMarkovModel``), so models with Markov
discrete structure need no enumeration machinery and the hot loop stays a
scan over time of logsumexp-matmul updates — exactly the shape XLA tiles
well (K x K dense ops, static trip count, no data-dependent control flow).

Extras beyond ``log_prob``/``sample``: ``posterior_mode`` (Viterbi) and
``posterior_sample`` (forward-filter backward-sample), both single-scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import logsumexp

from .distribution import Distribution

__all__ = ["HiddenMarkovModel"]


class HiddenMarkovModel(Distribution):
    """``HiddenMarkovModel(initial_logits (K,), transition_logits (K, K),
    observation_dist, num_steps)``.

    ``observation_dist`` has batch shape ``(K,)`` (one emission law per
    hidden state) and any event shape E; the HMM's event shape is
    ``(num_steps,) + E``.  Logits are unnormalized (log-softmax applied
    internally), so unconstrained ``param``/latent sites can feed them
    directly.  Batch HMMs: construct per-instance and ``vmap``."""

    _params = ("initial_logits", "transition_logits", "observation_dist")
    reparametrized = False

    def __init__(self, initial_logits, transition_logits, observation_dist,
                 num_steps):
        initial_logits = jnp.asarray(initial_logits)
        transition_logits = jnp.asarray(transition_logits)
        if initial_logits.ndim != 1 or transition_logits.ndim != 2:
            raise ValueError(
                "batched HMMs are not supported directly; vmap over "
                "per-instance constructions instead"
            )
        k = initial_logits.shape[0]
        if transition_logits.shape != (k, k):
            raise ValueError(
                f"transition_logits must be ({k}, {k}), got "
                f"{transition_logits.shape}"
            )
        if observation_dist.batch_shape != (k,):
            raise ValueError(
                f"observation_dist batch shape {observation_dist.batch_shape}"
                f" must be exactly ({k},) — one emission law per state; "
                "extra leading batch dims are not supported (vmap instead)"
            )
        self.initial_logits = initial_logits
        self.transition_logits = transition_logits
        self.observation_dist = observation_dist
        self.num_steps = int(num_steps)
        super().__init__(
            (), (self.num_steps,) + tuple(observation_dist.event_shape)
        )

    @property
    def num_states(self):
        return self.initial_logits.shape[0]

    def expand(self, batch_shape):
        """iid batch of the SAME chain (params shared, not broadcast):
        ``log_prob`` already accepts leading batch dims on x; ``sample``
        folds batch_shape into the draw shape."""
        batch_shape = jax.lax.broadcast_shapes(self.batch_shape,
                                               tuple(batch_shape))
        new = object.__new__(type(self))
        for k, v in self.__dict__.items():
            object.__setattr__(new, k, v)
        object.__setattr__(new, "_batch_shape", batch_shape)
        return new

    @property
    def support(self):
        return self.observation_dist.support

    # ------------------------------------------------------------------
    def _log_init(self):
        return jax.nn.log_softmax(self.initial_logits)

    def _log_trans(self):
        return jax.nn.log_softmax(self.transition_logits, axis=-1)

    def _obs_lp(self, x):
        """x (..., T, *E) -> per-state emission log-probs (T, ..., K)."""
        ev = len(self.observation_dist.event_shape)
        x_exp = jnp.expand_dims(x, axis=-1 - ev)          # (..., T, 1, *E)
        lp = self.observation_dist.log_prob(x_exp)        # (..., T, K)
        return jnp.moveaxis(lp, -2, 0)                    # (T, ..., K)

    def _forward(self, x):
        """All filtered log alphas (T, ..., K) — shared by log_prob/FFBS."""
        lp = self._obs_lp(x)
        log_trans = self._log_trans()
        alpha0 = self._log_init() + lp[0]

        def step(alpha, lp_t):
            a = logsumexp(alpha[..., :, None] + log_trans, axis=-2) + lp_t
            return a, a

        _, alphas = lax.scan(step, alpha0, lp[1:])
        return jnp.concatenate([alpha0[None], alphas], axis=0)

    def log_prob(self, x):
        return logsumexp(self._forward(x)[-1], axis=-1)

    # ------------------------------------------------------------------
    def sample(self, key, sample_shape=()):
        """States by ancestral Categorical scan; emissions drawn for all K
        states at once and selected by the sampled path (vectorized; K-fold
        extra draws buys zero gathers of distribution pytrees)."""
        shape = tuple(sample_shape) + self.batch_shape
        k_state, k_obs = jax.random.split(key)
        log_trans = self._log_trans()

        z0 = jax.random.categorical(
            jax.random.fold_in(k_state, 0), self._log_init(),
            shape=shape)

        def step(z, t):
            zt = jax.random.categorical(
                jax.random.fold_in(k_state, t), log_trans[z])
            return zt, zt

        _, zs = lax.scan(step, z0, jnp.arange(1, self.num_steps))
        z = jnp.concatenate([z0[None], zs], axis=0)       # (T, ...)

        draws = self.observation_dist.sample(
            k_obs, (self.num_steps,) + shape)             # (T, ..., K, *E)
        ev = len(self.observation_dist.event_shape)
        z_idx = z.reshape(z.shape + (1,) * (ev + 1))
        x = jnp.take_along_axis(draws, z_idx, axis=len(shape) + 1)
        x = jnp.squeeze(x, axis=len(shape) + 1)           # (T, ..., *E)
        return jnp.moveaxis(x, 0, len(shape))             # (..., T, *E)

    # ------------------------------------------------------------------
    def posterior_mode(self, x):
        """Viterbi MAP state path for observations x (T, *E) -> (T,) int."""
        lp = self._obs_lp(x)                              # (T, K)
        log_trans = self._log_trans()

        def fwd(delta, lp_t):
            scores = delta[:, None] + log_trans           # (K_prev, K)
            ptr = jnp.argmax(scores, axis=0)
            return jnp.max(scores, axis=0) + lp_t, ptr

        delta, ptrs = lax.scan(fwd, self._log_init() + lp[0], lp[1:])
        z_last = jnp.argmax(delta)

        def back(z, ptr):
            zp = ptr[z]
            return zp, zp

        _, path = lax.scan(back, z_last, ptrs, reverse=True)
        return jnp.concatenate([path, z_last[None]])

    def posterior_sample(self, key, x, sample_shape=()):
        """Forward-filter backward-sample: exact joint posterior draws of
        the state path given x (T, *E); returns (*sample_shape, T)."""
        alphas = self._forward(x)                         # (T, K)
        log_trans = self._log_trans()
        shape = tuple(sample_shape)

        z_last = jax.random.categorical(
            jax.random.fold_in(key, self.num_steps - 1), alphas[-1],
            shape=shape)

        def back(z, inp):
            t, alpha_t = inp
            logits = alpha_t[..., :, None] + log_trans    # (K_t, K_{t+1})
            zt = jax.random.categorical(
                jax.random.fold_in(key, t), logits.T[z])
            return zt, zt

        ts = jnp.arange(self.num_steps - 1)
        _, zs = lax.scan(back, z_last, (ts, alphas[:-1]), reverse=True)
        z = jnp.concatenate([zs, z_last[None]], axis=0)   # (T, ...)
        return jnp.moveaxis(z, 0, -1) if shape else z
