"""Example 4 — Gaussian mixture model via SMC with sharded particles.

Blueprint: SURVEY.md C19 (BASELINE.json configs[3]: "Gaussian mixture model
via SMC with sharded particles + systematic resampling collectives").

The assignment variable is marginalised (MixtureSameFamily) so the target is
continuous and multimodal-by-symmetry — exactly the regime where tempered SMC
with mutation beats single-chain MCMC.  The label-permutation symmetry is kept
(no artificial ordering constraint); correctness is judged on label-invariant
functionals (posterior-predictive density vs the true generating mixture).

Run: ``python -m bayesic_tpu.models.gmm --smoke true``
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import dist
from ..core import sample
from ..infer.smc import SMC
from ..ops.gmm_logprob import (
    _reference_value_and_grad,
    gmm_loglik,
    gmm_loglik_grad,
    gmm_loglik_reference,
    use_kernel,
)
from ..utils.config import dump_config, parse_config
from .common import bench_line, timed_steps


@dataclasses.dataclass(frozen=True)
class Config:
    num_components: int = 3
    data_dim: int = 2
    num_data: int = 1000
    num_particles: int = 4096
    mutation_steps: int = 5
    leapfrog_steps: int = 5
    seed: int = 0
    smoke: bool = False
    bench: bool = False


def make_data(cfg: Config):
    rng = np.random.default_rng(cfg.seed)
    k, d = cfg.num_components, cfg.data_dim
    centers = rng.normal(0, 4.0, (k, d)).astype(np.float32)
    scales = np.full((k,), 0.7, np.float32)
    weights = rng.dirichlet(np.full(k, 5.0)).astype(np.float32)
    comps = rng.choice(k, cfg.num_data, p=weights)
    x = (centers[comps]
         + rng.normal(0, 1, (cfg.num_data, d)) * scales[comps, None]) \
        .astype(np.float32)
    return jnp.asarray(x), dict(centers=centers, scales=scales,
                                weights=weights)


def make_model(cfg: Config, x):
    k, d = cfg.num_components, cfg.data_dim

    def model():
        w = sample("weights", dist.Dirichlet(jnp.ones(k)))
        mus = sample("mus", dist.Normal(0.0, 5.0).expand((k, d)).to_event(2))
        sigma = sample("sigma",
                       dist.HalfNormal(2.0).expand((k,)).to_event(1))
        comps = dist.Independent(dist.Normal(mus, sigma[:, None]), 1)
        mix = dist.MixtureSameFamily(dist.Categorical(probs=w), comps)
        sample("obs", mix.expand((x.shape[0],)).to_event(1), obs=x)

    return model


def make_batched_loglik(info, unravel, x, interpret=False, reference=False):
    """Batched likelihood over flat particle vectors using the fused
    gmm_loglik kernel (SURVEY.md C14b), or with ``reference`` the plain
    reference; plugs into SMC's ``batched_loglik=`` to bypass
    vmap-of-replay on the data term."""
    t_w = info.transforms["weights"]
    t_s = info.transforms["sigma"]

    def loglik(qs):
        u = unravel(qs)
        w = t_w.forward(u["weights"])          # (P, K) simplex
        sig = t_s.forward(u["sigma"])          # (P, K)
        if reference:
            return gmm_loglik_reference(x, jnp.log(w), u["mus"], sig)
        return gmm_loglik(x, jnp.log(w), u["mus"], sig, interpret)

    return loglik


def make_batched_loglik_grad(info, unravel, ravel, x, interpret=False,
                             reference=False):
    """Fused value+gradient of the likelihood wrt the flat UNCONSTRAINED
    particle vector — the SMC mutation hot path (SURVEY.md C14a): the
    kernel (or with ``reference`` the reference's ``jax.grad``) returns
    (ll, d/dlogw, d/dmus, d/dsig) and the (elementwise, XLA-fused)
    transform chain pulls the gradient back to unconstrained space via
    jax.vjp — no hand-derived stick-breaking."""
    vg = (_reference_value_and_grad if reference else
          functools.partial(gmm_loglik_grad, interpret=interpret))
    t_w = info.transforms["weights"]
    t_s = info.transforms["sigma"]

    def loglik_vg(qs):
        u = unravel(qs)

        def to_params(uw, us):
            w = t_w.forward(uw)
            sig = t_s.forward(us)
            return jnp.log(w), sig

        (logw, sig), vjp_t = jax.vjp(to_params, u["weights"], u["sigma"])
        ll, dlogw, dmus, dsig = vg(x, logw, u["mus"], sig)
        duw, dus = vjp_t((dlogw, dsig))
        return ll, ravel({"weights": duw, "mus": dmus, "sigma": dus})

    return loglik_vg


def _true_loglik(x, truth):
    from scipy.stats import multivariate_normal
    xn = np.asarray(x)
    dens = np.zeros(xn.shape[0])
    for wk, ck, sk in zip(truth["weights"], truth["centers"],
                          truth["scales"]):
        dens += wk * multivariate_normal(
            ck, sk**2 * np.eye(xn.shape[1])
        ).pdf(xn)
    return float(np.log(dens).mean())


def predictive_loglik(res, x, cfg, num_particles_eval=256):
    """Label-invariant check: posterior-averaged predictive density."""
    k, d = cfg.num_components, cfg.data_dim
    w = jnp.exp(res.log_weights)
    idx = jnp.argsort(-w)[:num_particles_eval]
    ws = w[idx] / w[idx].sum()

    def one(i):
        mus = res.particles["mus"][i]
        sig = res.particles["sigma"][i]
        pw = res.particles["weights"][i]
        comps = dist.Independent(dist.Normal(mus, sig[:, None]), 1)
        mix = dist.MixtureSameFamily(dist.Categorical(probs=pw), comps)
        return mix.log_prob(x)  # (n,)

    lps = jax.vmap(one)(idx)  # (P, n)
    from jax.scipy.special import logsumexp
    avg = logsumexp(lps + jnp.log(ws)[:, None], axis=0)
    return float(avg.mean())


def make_smc(cfg: Config, x, kernel, interpret=False, reference=False,
             **smc_kwargs):
    """GMM SMC; with ``kernel`` the likelihood and its gradient come from
    the fused gmm_loglik kernel (ops/gmm_logprob.py) through SMC's
    ``batched_loglik`` hooks, else from the model's own log-density.
    ``reference`` puts the plain reference behind the same hooks: timed
    against the kernel, it separates the kernel's gain from the hooks'."""
    model = make_model(cfg, x)
    kw = dict(num_particles=cfg.num_particles,
              mutation_steps=cfg.mutation_steps,
              hmc_leapfrog_steps=cfg.leapfrog_steps, **smc_kwargs)
    smc = SMC(model, **kw)
    if not kernel:
        return smc
    return SMC(model,
               batched_loglik=make_batched_loglik(
                   smc.info, smc._unravel, x, interpret, reference),
               batched_loglik_grad=make_batched_loglik_grad(
                   smc.info, smc._unravel, smc._ravel, x, interpret,
                   reference),
               **kw)


def run(cfg: Config, key=None, particle_sharding=None, kernel=None,
        interpret=False, smc_kwargs=None):
    """``kernel=None`` takes the kernel where it compiles (a GPU) and the
    model's own likelihood on the CPU."""
    if cfg.smoke:
        cfg = dataclasses.replace(cfg, num_data=200, num_particles=512,
                                  mutation_steps=2, leapfrog_steps=3)
    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    x, truth = make_data(cfg)
    if kernel is None:
        kernel = use_kernel(interpret)
    smc = make_smc(cfg, x, kernel, interpret,
                   particle_sharding=particle_sharding, **(smc_kwargs or {}))

    if cfg.bench:
        res, dt = timed_steps(lambda: smc.run(key), warmup_runs=1,
                              timed_runs=1)
        bench_line("smc_particles_per_s",
                   cfg.num_particles * int(res.num_stages) / dt,
                   "particle-stages/s", model="gmm",
                   particles=cfg.num_particles,
                   stages=int(res.num_stages))
    else:
        res = smc.run(key)

    pred = predictive_loglik(res, x, cfg)
    ref = _true_loglik(x, truth)
    return {
        "pred_loglik": pred,
        "true_loglik": ref,
        "gap": ref - pred,
        "log_evidence": float(res.log_evidence),
        "num_stages": int(res.num_stages),
        "accept_rate": float(res.accept_rate),
        "result": res,
    }


def main(argv=None):
    cfg = parse_config(Config, argv)
    print(dump_config(cfg))
    out = run(cfg)
    print(f"posterior predictive loglik = {out['pred_loglik']:.3f} "
          f"(true-model {out['true_loglik']:.3f}, gap {out['gap']:.3f})")
    print(f"logZ = {out['log_evidence']:.1f}, stages = {out['num_stages']}, "
          f"accept = {out['accept_rate']:.2f}")


if __name__ == "__main__":
    main()
