"""Model-DSL primitives: ``sample``, ``plate``, ``param``, ``deterministic``,
``factor``.

Blueprint: SURVEY.md C3 — "declare latent sites + observed likelihoods with
plate batch structure; produces a model graph/trace" via effect-handler
tracing (the composable-effects design of PAPERS.md [NumPyro], re-implemented
from scratch).  A model is an ordinary Python function that calls these
primitives; handlers (handlers.py) intercept the messages to seed, trace,
substitute, or condition the program.  Everything a handler does happens at
JAX *trace* time, so the compiled log-joint (SURVEY.md C4) is pure XLA with no
Python in the hot loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..dist import constraints
from ..dist.distribution import Distribution

__all__ = ["sample", "plate", "param", "deterministic", "factor",
           "apply_stack", "HANDLER_STACK"]

# Innermost handler is last. Module-level (single-threaded tracing is the JAX
# norm; handlers are only active during Python tracing, never inside XLA).
HANDLER_STACK: list = []


def _new_msg(type_, name, **kw):
    msg = dict(
        type=type_,
        name=name,
        value=None,
        is_observed=False,
        scale=1.0,
        key=None,
        plates=(),          # tuple of active plate handlers
        stop=False,
        dist=None,
    )
    msg.update(kw)
    return msg


def apply_stack(msg):
    """Run a message through the handler stack: innermost handlers first for
    ``process_message``, then the default behavior, then ``postprocess`` in
    reverse order."""
    pointer = 0
    for pointer, handler in enumerate(reversed(HANDLER_STACK)):
        handler.process_message(msg)
        if msg["stop"]:
            break
    default_process(msg)
    for handler in HANDLER_STACK[len(HANDLER_STACK) - pointer - 1:]:
        handler.postprocess_message(msg)
    return msg


def default_process(msg):
    if msg["value"] is not None:
        return
    t = msg["type"]
    if t == "sample":
        if msg["key"] is None:
            raise RuntimeError(
                f"sample site {msg['name']!r} has no value and no PRNG key — "
                f"wrap the model in handlers.seed(...) or pass obs=."
            )
        msg["value"] = msg["dist"].sample(msg["key"],
                                          msg.get("sample_shape", ()))
    elif t == "subsample":
        size, ssize = msg["size"], msg["subsample_size"]
        if ssize is None or ssize >= size:
            msg["value"] = jnp.arange(size)
        else:
            if msg["key"] is None:
                raise RuntimeError(
                    f"plate {msg['name']!r} subsampling needs a PRNG key — "
                    f"wrap the model in handlers.seed(...)."
                )
            if msg.get("replacement", True):
                # With-replacement draw: unbiased ELBO terms, O(B) instead of
                # the O(N log N) permutation (hot-loop friendly).
                msg["value"] = jax.random.randint(
                    msg["key"], (ssize,), 0, size
                )
            else:
                msg["value"] = jax.random.choice(
                    msg["key"], size, (ssize,), replace=False
                )
    elif t == "param":
        if msg["value"] is None:
            msg["value"] = msg["init_value"]
    elif t in ("deterministic", "factor"):
        pass
    else:
        raise ValueError(f"unknown message type {t!r}")


def sample(name, fn, obs=None, rng_key=None, sample_shape=(), infer=None):
    """Declare a random variable ``name`` with distribution ``fn``; if ``obs``
    is given the site is an observed likelihood term.  ``infer`` carries
    inference hints, e.g. ``{"enumerate": True}`` to marginalise a small
    discrete site out of the log-joint (SURVEY.md C4 periphery)."""
    if not isinstance(fn, Distribution):
        raise TypeError(f"sample({name!r}): fn must be a Distribution")
    if not HANDLER_STACK and obs is None and rng_key is None:
        raise RuntimeError(
            f"sample({name!r}) outside any handler needs rng_key="
        )
    msg = _new_msg(
        "sample", name, dist=fn, value=obs,
        is_observed=obs is not None, key=rng_key, sample_shape=sample_shape,
        infer=infer or {},
    )
    apply_stack(msg)
    return msg["value"]


def param(name, init_value=None, constraint=constraints.real):
    """Declare a learnable parameter site (used by DSL-authored guides,
    SURVEY.md C6)."""
    msg = _new_msg("param", name, init_value=init_value, constraint=constraint)
    apply_stack(msg)
    return msg["value"]


def deterministic(name, value):
    """Record a derived quantity in the trace."""
    msg = _new_msg("deterministic", name, value=value)
    apply_stack(msg)
    return msg["value"]


def factor(name, log_factor):
    """Add an arbitrary term to the joint log-density."""
    msg = _new_msg("factor", name, value=log_factor)
    apply_stack(msg)
    return msg["value"]


class plate:
    """Conditionally-independent batch dimension with optional mini-batch
    subsampling (SURVEY.md C5: "mini-batch likelihood scaling N/B").

    Usage::

        with plate("data", size=N, subsample_size=B) as idx:
            sample("obs", dist.Normal(mu[idx], 1.0), obs=y[idx])

    Sites sampled inside get ``scale *= size / len(idx)`` so subsampled
    log-densities are unbiased estimates of the full-data ones.  The
    subsample indices are themselves a (substitutable) site named
    ``"{name}__idx"`` so a replayed log-joint sees the same mini-batch.
    """

    def __init__(self, name, size, subsample_size=None, dim=None,
                 replacement=True):
        self.name = name
        self.size = int(size)
        self.subsample_size = (
            None if subsample_size is None else int(subsample_size)
        )
        if dim not in (None, -1):
            # silently ignoring NumPyro-style dim placement would let
            # models rely on axis positioning that never happens
            raise NotImplementedError(
                "plate(dim=...) is not supported; batch dims are "
                "right-aligned (the dim=-1 convention)"
            )
        self.dim = dim
        self.replacement = replacement
        self.indices = None

    @property
    def scale(self):
        if self.subsample_size is None or self.subsample_size >= self.size:
            return 1.0
        return self.size / self.subsample_size

    def __enter__(self):
        if self.indices is None:
            # first entry emits the (substitutable) index site; re-entry
            # reuses the SAME indices so a plate object used as a context
            # manager twice sees one consistent mini-batch (and the trace
            # does not hit a duplicate-site error)
            msg = _new_msg(
                "subsample", self.name + "__idx", size=self.size,
                subsample_size=self.subsample_size,
                replacement=self.replacement,
            )
            apply_stack(msg)
            self.indices = msg["value"]
        HANDLER_STACK.append(self)
        return self.indices

    def __exit__(self, *exc):
        assert HANDLER_STACK[-1] is self
        HANDLER_STACK.pop()
        return False

    # -- as a handler on the stack ----------------------------------------
    def process_message(self, msg):
        if msg["type"] in ("sample", "factor"):
            msg["scale"] = msg["scale"] * self.scale
            msg["plates"] = msg["plates"] + (self,)

    def postprocess_message(self, msg):
        pass
