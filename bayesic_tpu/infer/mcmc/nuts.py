"""Iterative multinomial NUTS as one compiled XLA loop.

Blueprint: SURVEY.md C8 and §7 hard-part 2: "tree doubling is
recursion+early-exit; compiled, it must be an iterative while_loop with static
max_tree_depth, fully vmap-compatible (per-chain divergent tree depths =>
masked lockstep work)".  Design follows the iterative tree-building +
checkpoint U-turn scheme of modern accelerator NUTS implementations
(PAPERS.md: "Efficiently Vectorized MCMC on Modern Accelerators"; tfp.mcmc
paper), written from scratch:

* Outer ``while_loop`` doubles the trajectory up to ``max_depth`` times,
  growing in a uniformly random direction each doubling; proposals merge by
  biased progressive multinomial sampling (weight = exp(-ΔH)).
* Each subtree of 2^j leaves is built by ONE inner ``while_loop`` doing one
  leapfrog per iteration; U-turn checks that the recursive algorithm does on
  every balanced subtree are reproduced with O(max_depth) checkpoint slots:
  leaf ``n`` (0-based, even) is stored at slot ``popcount(n)``; leaf ``n``
  (odd, with ``t`` trailing one-bits) checks against slots
  ``popcount(n)-t .. popcount(n)-1`` — exactly the left endpoints of the
  balanced subtrees ending at ``n``.

Everything is fixed-shape, so ``vmap`` lifts whole chains into lockstep
batched execution (chains that finish early mask out — SURVEY.md C13a).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .integrators import IntegratorState, make_leapfrog
from .metrics import kinetic_energy, sample_momentum, velocity

__all__ = ["NUTSInfo", "make_nuts_kernel"]


class NUTSInfo(NamedTuple):
    accept_prob: jax.Array     # mean leaf acceptance statistic (for DA)
    diverging: jax.Array
    depth: jax.Array           # tree depth reached
    num_steps: jax.Array       # leapfrog evaluations this transition
    energy: jax.Array          # H at trajectory start
    is_accepted: jax.Array     # proposal != initial point


def _popcount(n):
    return lax.population_count(n)


def _trailing_ones(n):
    return _popcount(jnp.bitwise_xor(n, n + 1)) - 1


def _is_turning(inv_mass, q_l, v_l, q_r, v_r, sign=1.0):
    """Generalized-NUTS U-turn criterion on the TIME-ordered span
    (q_l earlier, q_r later).  ``sign`` corrects a span supplied in BUILD
    order: subtrees grown backward (direction=-1) visit later-time points
    first, so their build-order displacement is the negative of the
    time-order one while the velocities stay time-forward — without the
    correction every >=2-leaf backward subtree looks like a U-turn
    (verified: a flat-potential trajectory, which can never turn,
    terminated at depths 2-4 instead of max_depth)."""
    dq = (q_r - q_l) * sign
    return jnp.logical_or(
        jnp.sum(dq * v_l, -1) < 0.0, jnp.sum(dq * v_r, -1) < 0.0
    )


class _TreeCarry(NamedTuple):
    depth: jax.Array
    left: IntegratorState
    right: IntegratorState
    q_prop: jax.Array
    pe_prop: jax.Array
    grad_prop: jax.Array
    log_weight: jax.Array
    sum_accept: jax.Array
    num_leaves: jax.Array
    num_steps: jax.Array
    turning: jax.Array
    diverging: jax.Array


class _SubtreeCarry(NamedTuple):
    i: jax.Array               # leaf counter within the subtree
    state: IntegratorState
    q_prop: jax.Array
    pe_prop: jax.Array
    grad_prop: jax.Array
    log_weight: jax.Array      # logsumexp of leaf weights so far (-inf init)
    sum_accept: jax.Array
    turning: jax.Array
    diverging: jax.Array
    q_ckpt: jax.Array          # (max_depth, d)
    v_ckpt: jax.Array          # (max_depth, d)


def make_nuts_kernel(potential_and_grad, max_depth=10,
                     divergence_threshold=1000.0):
    """Returns ``step(key, state, step_size, inv_mass) -> (state, info)``
    where ``state`` is an :class:`IntegratorState` (momentum ignored on
    input).  Pure function of its inputs; vmap over chains."""

    leapfrog = make_leapfrog(potential_and_grad)

    def _build_subtree(key, edge: IntegratorState, direction, depth,
                       step_size, inv_mass, h0):
        d = edge.q.shape[-1]
        n_leaves = jnp.asarray(1, jnp.int32) << depth
        eps = direction.astype(edge.q.dtype) * step_size

        def cond(c: _SubtreeCarry):
            return jnp.logical_and(
                c.i < n_leaves,
                jnp.logical_and(~c.turning, ~c.diverging),
            )

        def body(c: _SubtreeCarry):
            state = leapfrog(c.state, eps, inv_mass)
            ke = kinetic_energy(inv_mass, state.p)
            delta = state.pe + ke - h0
            delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
            diverging = delta > divergence_threshold
            log_w = -delta
            log_weight = jnp.logaddexp(c.log_weight, log_w)
            # progressive multinomial proposal within the subtree
            u = jax.random.uniform(jax.random.fold_in(key, c.i))
            take = jnp.log(u) < (log_w - log_weight)
            q_prop = jnp.where(take, state.q, c.q_prop)
            pe_prop = jnp.where(take, state.pe, c.pe_prop)
            grad_prop = jnp.where(take, state.grad, c.grad_prop)
            sum_accept = c.sum_accept + jnp.minimum(1.0, jnp.exp(-delta))

            v = velocity(inv_mass, state.p)
            # even leaf: checkpoint at slot popcount(i)
            slot = _popcount(c.i)
            is_even = (c.i & 1) == 0
            q_ckpt = jnp.where(
                is_even,
                c.q_ckpt.at[slot % max_depth].set(state.q),
                c.q_ckpt,
            )
            v_ckpt = jnp.where(
                is_even,
                c.v_ckpt.at[slot % max_depth].set(v),
                c.v_ckpt,
            )
            # odd leaf: U-turn checks against open checkpoints
            t_ones = _trailing_ones(c.i)
            idx_max = _popcount(c.i) - 1
            idx_min = idx_max - t_ones + 1

            def check(s, turning):
                active = jnp.logical_and(s >= idx_min, s <= idx_max)
                turn_s = _is_turning(
                    inv_mass, q_ckpt[s % max_depth], v_ckpt[s % max_depth],
                    state.q, v, sign=direction.astype(state.q.dtype),
                )
                return jnp.logical_or(turning, jnp.logical_and(active, turn_s))

            turning = lax.fori_loop(
                0, max_depth, check, jnp.asarray(False)
            )
            turning = jnp.where(is_even, False, turning)

            return _SubtreeCarry(
                c.i + 1, state, q_prop, pe_prop, grad_prop, log_weight,
                sum_accept, turning, diverging, q_ckpt, v_ckpt,
            )

        init = _SubtreeCarry(
            jnp.zeros((), jnp.int32), edge,
            edge.q, edge.pe, edge.grad,
            jnp.asarray(-jnp.inf, edge.q.dtype),
            jnp.zeros((), edge.q.dtype),
            jnp.asarray(False), jnp.asarray(False),
            jnp.zeros((max_depth, d), edge.q.dtype),
            jnp.zeros((max_depth, d), edge.q.dtype),
        )
        out = lax.while_loop(cond, body, init)
        return out

    def step(key, state: IntegratorState, step_size, inv_mass):
        key_mom, key_tree = jax.random.split(key)
        p0 = sample_momentum(key_mom, inv_mass, state.q)
        h0 = state.pe + kinetic_energy(inv_mass, p0)
        start = IntegratorState(state.q, p0, state.pe, state.grad)

        def cond(c: _TreeCarry):
            return jnp.logical_and(
                c.depth < max_depth,
                jnp.logical_and(~c.turning, ~c.diverging),
            )

        def body(c: _TreeCarry):
            key_d = jax.random.fold_in(key_tree, c.depth)
            key_dir, key_sub, key_acc = jax.random.split(key_d, 3)
            go_right = jax.random.bernoulli(key_dir)
            direction = jnp.where(go_right, 1, -1).astype(jnp.int32)
            edge = jax.tree_util.tree_map(
                lambda r, l: jnp.where(go_right, r, l), c.right, c.left
            )
            sub = _build_subtree(
                key_sub, edge, direction, c.depth, step_size, inv_mass, h0
            )
            sub_steps = sub.i
            bad = jnp.logical_or(sub.turning, sub.diverging)

            # merge proposal (only if subtree is clean): biased progressive
            accept_p = jnp.minimum(
                1.0, jnp.exp(sub.log_weight - c.log_weight)
            )
            take = jnp.logical_and(
                ~bad, jax.random.uniform(key_acc) < accept_p
            )
            q_prop = jnp.where(take, sub.q_prop, c.q_prop)
            pe_prop = jnp.where(take, sub.pe_prop, c.pe_prop)
            grad_prop = jnp.where(take, sub.grad_prop, c.grad_prop)
            log_weight = jnp.where(
                bad, c.log_weight, jnp.logaddexp(c.log_weight, sub.log_weight)
            )

            # extend edges (only if clean)
            def upd(new, old):
                return jnp.where(jnp.logical_and(~bad, go_right), new, old)

            def upd_l(new, old):
                return jnp.where(jnp.logical_and(~bad, ~go_right), new, old)

            right = jax.tree_util.tree_map(
                lambda n, o: upd(n, o), sub.state, c.right
            )
            left = jax.tree_util.tree_map(
                lambda n, o: upd_l(n, o), sub.state, c.left
            )

            # full-trajectory U-turn (after a clean merge)
            full_turn = _is_turning(
                inv_mass, left.q, velocity(inv_mass, left.p),
                right.q, velocity(inv_mass, right.p),
            )
            turning = jnp.logical_or(
                sub.turning, jnp.logical_and(~bad, full_turn)
            )

            return _TreeCarry(
                c.depth + 1, left, right, q_prop, pe_prop, grad_prop,
                log_weight, c.sum_accept + sub.sum_accept,
                c.num_leaves + sub.i, c.num_steps + sub_steps,
                turning, jnp.logical_or(c.diverging, sub.diverging),
            )

        zero = jnp.zeros((), state.q.dtype)
        init = _TreeCarry(
            jnp.zeros((), jnp.int32), start, start,
            start.q, start.pe, start.grad,
            zero,                      # log weight of the root leaf: exp(0)
            zero, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
            jnp.asarray(False), jnp.asarray(False),
        )
        out = lax.while_loop(cond, body, init)

        new_state = IntegratorState(
            out.q_prop, jnp.zeros_like(p0), out.pe_prop, out.grad_prop
        )
        accept_prob = out.sum_accept / jnp.maximum(
            out.num_leaves.astype(zero.dtype), 1.0
        )
        info = NUTSInfo(
            accept_prob, out.diverging, out.depth, out.num_steps, h0,
            jnp.any(out.q_prop != state.q),
        )
        return new_state, info

    return step
