"""Fused GMM log-likelihood and gradient: a Pallas kernel through Triton.

The op: for a batch of P particles, each holding a K-component isotropic
Gaussian mixture (log-weights (P,K), means (P,K,D), scales (P,K)), compute
``out[p] = sum_n logsumexp_k [ logw_pk + log N(x_n; mu_pk, sig_pk I) ]``
over a shared dataset x (N,D), and optionally its gradient with respect to
the three parameter arrays.

Why a kernel: ``jax.grad`` of the plain formulation materialises the
(P,K,N) responsibilities in device memory (196 MB per evaluation at the
benchmark shape P=8192, N=2000, K=3), and the SMC mutation makes about 30
evaluations per stage.  The kernel keeps x (16 KB) cache-resident and reads
it once per particle block: each program owns a block of particles, walks N
in short steps of an in-kernel loop, and accumulates the
log-likelihood together with the sufficient sums behind the gradient
(``sum_n r``, ``sum_n r q``, ``sum_n r (x - mu)``) in registers.  Only
O(P*K*D) numbers are written.

Layout: every per-particle array travels transposed, one row per (k, d)
entry and particles along the columns, so a program's loads are
contiguous power-of-two vectors of particles.  x travels as (D, N)
rows.  D and K are unrolled statically, so neither needs padding; the tail
of N is masked, and padded particles carry sigma = 1 and are sliced off.
The squared distance is formed elementwise as ``sum_d (x_d - mu_d)^2`` in
float32, with no matrix product, so no TF32 rounding enters the energies.

Dispatch is explicit (``gmm_loglik`` / ``gmm_loglik_grad``):

* on a GPU the compiled kernel runs, or the call raises;
* on the CPU the plain reference runs (the documented CPU path);
* ``interpret=True`` runs the kernel in the Pallas interpreter (tests).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

_LOG_2PI = math.log(2.0 * math.pi)
# (particles per program, data points per loop step, warps) for the value
# and the value+grad kernels, from a sweep on an H100 at P=8192, N=2000,
# K=3, D=2 (PERF.md, PR 1).  The gradient carries K*(2+D)+1 running
# (PB, BN) sums, so it wants a narrow step: past about 16 elements per
# thread per sum it spills registers and slows by 3x or more.
_BLOCK = {False: (16, 64, 4), True: (16, 16, 4)}


def gmm_loglik_reference(x, log_w, mus, sigmas):
    """x (N,D); log_w (...,K); mus (...,K,D); sigmas (...,K) -> (...)."""
    d = x.shape[-1]
    diff = x[..., None, :, :] - mus[..., :, None, :]     # (...,K,N,D)
    q = jnp.sum(diff * diff, -1)                          # (...,K,N)
    ll = (
        log_w[..., :, None]
        - q / (2.0 * jnp.square(sigmas)[..., :, None])
        - d * jnp.log(sigmas)[..., :, None]
        - 0.5 * d * _LOG_2PI
    )
    return jnp.sum(logsumexp(ll, axis=-2), -1)


def _reference_value_and_grad(x, log_w, mus, sigmas):
    def f(lw, mu, sg):
        return jnp.sum(gmm_loglik_reference(x, lw, mu, sg))

    ll = gmm_loglik_reference(x, log_w, mus, sigmas)
    return (ll,) + jax.grad(f, argnums=(0, 1, 2))(log_w, mus, sigmas)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _kernel(xt_ref, lw_ref, mu_ref, sg_ref, *out_refs, k, d, n, nb, pb, bn,
            with_grad):
    from jax.experimental import pallas as pl

    cols = pl.ds(pl.program_id(0) * pb, pb)
    mu = [[mu_ref[kk * d + dd, cols] for dd in range(d)] for kk in range(k)]
    sg = [sg_ref[kk, cols] for kk in range(k)]                  # (PB,)
    half_prec = [0.5 / (s * s) for s in sg]
    const = [lw_ref[kk, cols] - d * jnp.log(sg[kk]) - 0.5 * d * _LOG_2PI
             for kk in range(k)]

    def body(j, acc):
        rows = pl.ds(j * bn, bn)
        xs = [xt_ref[dd, rows][None, :] for dd in range(d)]    # (1, BN)
        valid = (j * bn + jnp.arange(bn) < n)[None, :]
        qs, lls = [], []
        for kk in range(k):
            q = sum(jnp.square(xs[dd] - mu[kk][dd][:, None])
                    for dd in range(d))                         # (PB, BN)
            qs.append(q)
            lls.append(const[kk][:, None] - q * half_prec[kk][:, None])
        m = functools.reduce(jnp.maximum, lls)
        lse = m + jnp.log(sum(jnp.exp(ll - m) for ll in lls))
        # elementwise partial sums; the one cross-lane reduction per
        # accumulator happens after the loop
        ll_acc = acc[0] + jnp.where(valid, lse, 0.0)
        if not with_grad:
            return (ll_acc,)
        r_acc, rq_acc, rd_acc = acc[1:]
        r_new, rq_new, rd_new = [], [], []
        for kk in range(k):
            r = jnp.where(valid, jnp.exp(lls[kk] - lse), 0.0)
            r_new.append(r_acc[kk] + r)
            rq_new.append(rq_acc[kk] + r * qs[kk])
            rd_new.append(tuple(
                rd_acc[kk][dd] + r * (xs[dd] - mu[kk][dd][:, None])
                for dd in range(d)))
        return ll_acc, tuple(r_new), tuple(rq_new), tuple(rd_new)

    zero = jnp.zeros((pb, bn), jnp.float32)
    acc0 = (zero,)
    if with_grad:
        acc0 += ((zero,) * k, (zero,) * k, ((zero,) * d,) * k)
    acc = jax.tree_util.tree_map(lambda a: jnp.sum(a, axis=1),
                                 jax.lax.fori_loop(0, nb, body, acc0))

    out_refs[0][cols] = acc[0]
    if with_grad:
        _, dlw_ref, dmu_ref, dsg_ref = out_refs
        r_sum, rq_sum, rd_sum = acc[1:]
        for kk in range(k):
            s = sg[kk]
            dlw_ref[kk, cols] = r_sum[kk]
            for dd in range(d):
                dmu_ref[kk * d + dd, cols] = rd_sum[kk][dd] / (s * s)
            dsg_ref[kk, cols] = (rq_sum[kk] / (s * s * s)
                                 - d * r_sum[kk] / s)


def _kernel_call(x, log_w, mus, sigmas, *, with_grad, interpret):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    pb, bn, num_warps = _BLOCK[with_grad]
    p0, k = log_w.shape
    n, d = x.shape
    pad = (-p0) % pb
    p = p0 + pad
    nb = pl.cdiv(n, bn)
    f32 = jnp.float32

    def cols(a, fill=0.0):
        return jnp.pad(a.astype(f32).T, ((0, 0), (0, pad)),
                       constant_values=fill)

    xt = jnp.pad(x.astype(f32).T, ((0, 0), (0, nb * bn - n)))
    args = (xt, cols(log_w), cols(mus.reshape(p0, k * d)),
            cols(sigmas, fill=1.0))
    out_shape = [jax.ShapeDtypeStruct((p,), f32)]
    if with_grad:
        out_shape += [jax.ShapeDtypeStruct((k, p), f32),
                      jax.ShapeDtypeStruct((k * d, p), f32),
                      jax.ShapeDtypeStruct((k, p), f32)]
    outs = pl.pallas_call(
        functools.partial(_kernel, k=k, d=d, n=n, nb=nb, pb=pb, bn=bn,
                          with_grad=with_grad),
        out_shape=out_shape,
        grid=(p // pb,),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=2),
        interpret=interpret,
        name="gmm_loglik_grad" if with_grad else "gmm_loglik",
    )(*args)
    ll = outs[0][:p0]
    if not with_grad:
        return ll
    dlw, dmu, dsg = outs[1:]
    return (ll, dlw[:, :p0].T, dmu[:, :p0].T.reshape(p0, k, d),
            dsg[:, :p0].T)


# ---------------------------------------------------------------------------
# public entry points: explicit dispatch + custom VJP
# ---------------------------------------------------------------------------

def use_kernel(interpret=False):
    """The dispatch rule: True when the kernel runs (compiled on a GPU, or
    interpreted on request), False on the CPU, where the reference is the
    documented path.  Any other backend is an error."""
    if interpret:
        return True
    backend = jax.default_backend()
    if backend == "gpu":
        return True
    if backend == "cpu":
        return False
    raise NotImplementedError(
        f"gmm_loglik has no path for backend {backend!r}")


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def gmm_loglik(x, log_w, mus, sigmas, interpret=False):
    """Batched GMM log-likelihood: x (N,D), log_w (P,K), mus (P,K,D),
    sigmas (P,K) -> (P,)."""
    if use_kernel(interpret):
        return _kernel_call(x, log_w, mus, sigmas, with_grad=False,
                            interpret=interpret)
    return gmm_loglik_reference(x, log_w, mus, sigmas)


def _vjp_fwd(x, log_w, mus, sigmas, interpret):
    ll, dlw, dmu, dsg = gmm_loglik_grad(x, log_w, mus, sigmas,
                                        interpret=interpret)
    return ll, (x, dlw, dmu, dsg)


def _vjp_bwd(interpret, res, ct):
    x, dlw, dmu, dsg = res
    # the data cotangent is not implemented (no consumer differentiates
    # wrt x); NaN instead of silent zeros so an accidental consumer fails
    # loudly
    return (jnp.full_like(x, jnp.nan), ct[:, None] * dlw,
            ct[:, None, None] * dmu, ct[:, None] * dsg)


gmm_loglik.defvjp(_vjp_fwd, _vjp_bwd)


def gmm_loglik_grad(x, log_w, mus, sigmas, interpret=False):
    """Fused value + gradient: x (N,D), log_w (P,K), mus (P,K,D), sigmas
    (P,K) -> (ll (P,), dlogw (P,K), dmus (P,K,D), dsig (P,K)).  One kernel
    launch on a GPU; ``jax.grad`` of the reference on the CPU."""
    if use_kernel(interpret):
        return _kernel_call(x, log_w, mus, sigmas, with_grad=True,
                            interpret=interpret)
    return _reference_value_and_grad(x, log_w, mus, sigmas)
