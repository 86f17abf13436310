"""Normalizing-flow variational guide (inverse autoregressive flow).

Blueprint: SURVEY.md C6 — the guide family ladder mean-field -> full-rank ->
neural; this module adds the next rung: a non-Gaussian posterior
approximation q(u) built from a diagonal-Gaussian base and a stack of
gated inverse autoregressive flow layers (Kingma et al. 2016) with
MADE-masked (Germain et al. 2015) MLP conditioners.

Design: VI only ever evaluates log q at the guide's OWN samples,
so both sampling and density ride the *forward* (parallel) IAF direction —
one masked-matmul pass per layer, no sequential inversion anywhere.  All
masks are static 0/1 matrices baked at trace time, so every conditioner is
a dense matmul; the whole sample+logq path is a handful of (B, H) GEMMs.

Layer k (u is the running vector, flip(u) between layers varies ordering):

    (m, s) = MADE_k(u)          # s_j, m_j depend only on u_{<j}
    g      = sigmoid(s + 2)     # +2: near-identity init (g ~ 0.88)
    u      = g * u + (1 - g) * m
    logdet += sum(log g)

log q(u_K) = log N(eps; 0, I) - sum(base log_scale) - sum_k logdet_k.

Sticking-the-landing (VERDICT r2 item 7): STL needs log q with parameters
stopped *at the sampled point*, which for an IAF requires the sequential
inverse pass.  ``FlowGuide(..., stl=True)`` implements it: the inverse of
each layer is a ``lax.scan`` over coordinates (coordinate j's solve uses
the already-recovered u_{<j} through the masked conditioner), so the cost
is dim conditioner passes per layer — a fixed-depth masked scan that is
cheap at guide dimensions and pays for itself in gradient variance near
the optimum (where the STL estimator's variance -> 0).  Numerically the
inverse at the stopped parameters recovers exactly the eps that generated
the sample, so the logq VALUE is unchanged — only its gradient flows
through the sample path alone.  With ``stl=False`` (default) the guide
keeps the standard total-derivative estimator and ignores
``stop_gradient_q`` (NumPyro AutoIAF behavior).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .guides import _LOG_2PI, Guide, unraveler

__all__ = ["FlowGuide"]


def _set_coord(u, j, val):
    """u[..., j] = val with a traced index (scan-friendly)."""
    oh = jax.nn.one_hot(j, u.shape[-1], dtype=u.dtype)
    return u * (1.0 - oh) + val[..., None] * oh


def _made_masks(dim, hidden):
    """Static MADE masks for conditioner MLP dim -> hidden... -> 2*dim.

    Input degrees 1..D; hidden degrees cycle 1..max(D-1,1); output degree
    d: output j may depend on inputs with degree < d(j) (strict), giving
    the autoregressive property.  Returns ([W masks], out_mask)."""
    d_in = np.arange(1, dim + 1)
    masks = []
    prev = d_in
    for h in hidden:
        d_h = (np.arange(h) % max(dim - 1, 1)) + 1
        masks.append((d_h[None, :] >= prev[:, None]).astype(np.float32))
        prev = d_h
    out_mask = (d_in[None, None, :] > prev[:, None, None]).astype(np.float32)
    # (prev_h, 2, dim): same strict mask for both m and s heads
    out_mask = np.broadcast_to(out_mask, (len(prev), 2, dim))
    return [jnp.asarray(m) for m in masks], jnp.asarray(
        out_mask.reshape(len(prev), 2 * dim))


class FlowGuide(Guide):
    """``FlowGuide(info, num_flows=2, hidden=(64, 64))`` — IAF posterior.

    ``stats(params, key, num_draws)`` is Monte-Carlo (the pushforward has
    no closed-form moments)."""

    def __init__(self, info, num_flows=2, hidden=(64, 64), init_scale=0.1,
                 stl=False):
        self.dim, self.unravel, self.ravel = unraveler(info)
        self.num_flows = int(num_flows)
        self.hidden = tuple(int(h) for h in hidden)
        self.init_scale = float(init_scale)
        self.stl = bool(stl)
        self._masks, self._out_mask = _made_masks(self.dim, self.hidden)

    # ------------------------------------------------------------------
    def init(self, key, loc=None):
        if loc is None:
            loc = jnp.zeros(self.dim)
        else:
            loc = self.ravel(loc) if isinstance(loc, dict) else loc
        flows = []
        widths = (self.dim,) + self.hidden
        for k in range(self.num_flows):
            layer = {}
            for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
                kk = jax.random.fold_in(jax.random.fold_in(key, k), i)
                layer[f"w{i}"] = (jax.random.normal(kk, (a, b))
                                  / np.sqrt(a))
                layer[f"b{i}"] = jnp.zeros(b)
            # zero-init output head -> every flow starts at (m=0, s=0):
            # u <- sigmoid(2) * u, i.e. near-identity
            layer["w_out"] = jnp.zeros((widths[-1], 2 * self.dim))
            layer["b_out"] = jnp.zeros(2 * self.dim)
            flows.append(layer)
        return {
            "loc": loc,
            "log_scale": jnp.full(self.dim, math.log(self.init_scale)),
            "flows": flows,
        }

    def _conditioner(self, layer, u):
        h = u
        for i, mask in enumerate(self._masks):
            h = jnp.tanh(h @ (layer[f"w{i}"] * mask) + layer[f"b{i}"])
        out = h @ (layer["w_out"] * self._out_mask) + layer["b_out"]
        m, s = out[..., :self.dim], out[..., self.dim:]
        return m, s

    def _push(self, params, eps):
        """Base sample + flow stack.  eps (..., dim) -> (u, logq)."""
        u = params["loc"] + jnp.exp(params["log_scale"]) * eps
        logq = jnp.sum(-0.5 * eps * eps - 0.5 * _LOG_2PI
                       - params["log_scale"], -1)
        for k, layer in enumerate(params["flows"]):
            if k % 2 == 1:
                u = jnp.flip(u, axis=-1)
            m, s = self._conditioner(layer, u)
            g = jax.nn.sigmoid(s + 2.0)
            u = g * u + (1.0 - g) * m
            logq = logq - jnp.sum(jnp.log(g), -1)
            if k % 2 == 1:
                u = jnp.flip(u, axis=-1)
        return u, logq

    def _inverse_layer(self, layer, y):
        """Invert one gated-IAF layer: solve u from
        y = g(u) * u + (1 - g(u)) * m(u) coordinate-by-coordinate.  The
        conditioner is strictly autoregressive, so once u_{<j} is known,
        (m_j, s_j) are exact and u_j solves in closed form."""

        def step(u, j):
            m, s = self._conditioner(layer, u)
            g = jax.nn.sigmoid(s + 2.0)
            yj = jnp.take(y, j, axis=-1)
            gj = jnp.take(g, j, axis=-1)
            mj = jnp.take(m, j, axis=-1)
            uj = (yj - (1.0 - gj) * mj) / gj
            u = _set_coord(u, j, uj)
            return u, None

        u, _ = jax.lax.scan(step, jnp.zeros_like(y),
                            jnp.arange(self.dim))
        return u

    def log_prob_at(self, params, u):
        """log q_params(u) for an ARBITRARY point via the sequential
        inverse (the STL path; also useful for diagnostics)."""
        logdet = 0.0
        for k in range(self.num_flows - 1, -1, -1):
            layer = params["flows"][k]
            if k % 2 == 1:
                u = jnp.flip(u, axis=-1)
            u = self._inverse_layer(layer, u)
            m, s = self._conditioner(layer, u)
            g = jax.nn.sigmoid(s + 2.0)
            logdet = logdet + jnp.sum(jnp.log(g), -1)
            if k % 2 == 1:
                u = jnp.flip(u, axis=-1)
        eps = (u - params["loc"]) * jnp.exp(-params["log_scale"])
        return jnp.sum(-0.5 * eps * eps - 0.5 * _LOG_2PI
                       - params["log_scale"], -1) - logdet

    def sample_and_log_prob(self, params, key, sample_shape=(),
                            stop_gradient_q=False, ctx=None):
        eps = jax.random.normal(key, tuple(sample_shape) + (self.dim,),
                                jnp.result_type(float))
        flat, logq = self._push(params, eps)
        if stop_gradient_q and self.stl:
            # STL: evaluate log q at the sample with guide params STOPPED;
            # the inverse at the same parameter values recovers eps, so
            # the value matches `_push`'s logq — only gradients differ
            sg = jax.tree_util.tree_map(jax.lax.stop_gradient, params)
            logq = self.log_prob_at(sg, flat)
        return self.unravel(flat), logq

    # ------------------------------------------------------------------
    def stats(self, params, key=None, num_draws=4096):
        """Monte-Carlo unconstrained mean/std per site."""
        key = key if key is not None else jax.random.PRNGKey(0)
        eps = jax.random.normal(key, (int(num_draws), self.dim))
        flat, _ = self._push(params, eps)
        return (self.unravel(jnp.mean(flat, 0)),
                self.unravel(jnp.std(flat, 0)))
