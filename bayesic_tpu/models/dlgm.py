"""Example 5 — deep latent Gaussian model (DLGM) with a VAE-style amortized
guide, plus the 1024-chain NUTS variant.

Blueprint: SURVEY.md C20 (BASELINE.json configs[4]: "Deep latent Gaussian
model (VAE-style amortized guide), 1024 sharded NUTS chains").

This is the flagship model: the decoder/encoder MLPs are the matmul-heavy
compute (batched products that may run in bf16 via ``compute_dtype``),
local latents z ride the plate subsampling machinery, decoder weights are
`param` sites optimized jointly with the ELBO, and the NUTS variant shards
1024 chains over the mesh's ``chain`` axis (SURVEY.md C13a) to measure
effective-samples/s.

Amortized-guide scaling note: the model scales the in-plate prior and
likelihood terms by N/B, so the guide scales log q(z|x) by the same factor —
the estimator stays an unbiased mini-batch ELBO.

Run: ``python -m bayesic_tpu.models.dlgm --smoke true``
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .. import dist
from ..core import param, plate, sample
from ..dist import constraints
from ..infer.mcmc import MCMC
from ..infer.svi import SVI, NeuralGuide
from ..utils import diagnostics as diag
from ..utils.config import dump_config, parse_config
from .common import bench_line, timed_steps

_LOG_2PI = float(np.log(2.0 * np.pi))


@dataclasses.dataclass(frozen=True)
class Config:
    num_data: int = 10_000
    data_dim: int = 32
    latent_dim: int = 8
    hidden: int = 64
    batch_size: int = 256
    steps: int = 3000
    lr: float = 1e-3
    seed: int = 0
    # NUTS variant
    num_chains: int = 64
    nuts_batch: int = 4
    num_warmup: int = 300
    num_samples: int = 300
    smoke: bool = False
    bench: bool = False
    compute_dtype: str = "float32"   # "bfloat16": matmuls in bf16,
                                     # params stay float32


# ---------------------------------------------------------------------------
# two-layer tanh MLPs as plain JAX: a params pytree, init(key), apply
# ---------------------------------------------------------------------------

def _dense_init(key, fan_in, fan_out):
    """LeCun-normal kernel (truncated normal, variance 1/fan_in), zero
    bias."""
    std = 1.0 / np.sqrt(fan_in) / 0.87962566103423978
    kernel = std * jax.random.truncated_normal(key, -2.0, 2.0,
                                               (fan_in, fan_out))
    return {"kernel": kernel, "bias": jnp.zeros((fan_out,))}


def _dense(p, x, dtype):
    return x.astype(dtype) @ p["kernel"].astype(dtype) \
        + p["bias"].astype(dtype)


@dataclasses.dataclass(frozen=True)
class Decoder:
    """z (..., latent_dim) -> tanh(z W1 + b1) W2 + b2 (..., data_dim)."""
    latent_dim: int
    hidden: int
    data_dim: int
    dtype: Any = jnp.float32

    def init(self, key):
        k1, k2 = jax.random.split(key)
        return {"hidden": _dense_init(k1, self.latent_dim, self.hidden),
                "out": _dense_init(k2, self.hidden, self.data_dim)}

    def apply(self, params, z):
        h = jnp.tanh(_dense(params["hidden"], z, self.dtype))
        return _dense(params["out"], h, self.dtype).astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class Encoder:
    """x (..., data_dim) -> (mu, log_sigma), each (..., latent_dim)."""
    data_dim: int
    hidden: int
    latent_dim: int
    dtype: Any = jnp.float32

    def init(self, key):
        k1, k2, k3 = jax.random.split(key, 3)
        return {"hidden": _dense_init(k1, self.data_dim, self.hidden),
                "mu": _dense_init(k2, self.hidden, self.latent_dim),
                "log_sigma": _dense_init(k3, self.hidden, self.latent_dim)}

    def apply(self, params, x):
        h = jnp.tanh(_dense(params["hidden"], x, self.dtype))
        mu = _dense(params["mu"], h, self.dtype).astype(jnp.float32)
        log_sigma = _dense(params["log_sigma"], h, self.dtype) \
            .astype(jnp.float32)
        return mu, jnp.clip(log_sigma, -6.0, 3.0)


def make_data(cfg: Config):
    """Synthetic data from a random ground-truth DLGM."""
    rng = np.random.default_rng(cfg.seed)
    w1 = rng.normal(0, 1, (cfg.latent_dim, cfg.hidden)) / np.sqrt(
        cfg.latent_dim)
    w2 = rng.normal(0, 1, (cfg.hidden, cfg.data_dim)) / np.sqrt(cfg.hidden)
    z = rng.normal(0, 1, (cfg.num_data, cfg.latent_dim))
    x = np.tanh(z @ w1) @ w2 + rng.normal(0, 0.3, (cfg.num_data,
                                                   cfg.data_dim))
    return jnp.asarray(x.astype(np.float32))


def make_model_and_guide(cfg: Config, x):
    n = int(x.shape[0])
    cdtype = jnp.dtype(cfg.compute_dtype)
    dec = Decoder(cfg.latent_dim, cfg.hidden, cfg.data_dim, dtype=cdtype)
    enc = Encoder(cfg.data_dim, cfg.hidden, cfg.latent_dim, dtype=cdtype)
    dec_init = dec.init(jax.random.PRNGKey(cfg.seed))
    b = cfg.batch_size
    scale = n / b

    def model(xa):
        dec_params = param("decoder", init_value=dec_init)
        sigma_x = param("sigma_x", init_value=jnp.asarray(0.5),
                        constraint=constraints.positive)
        with plate("data", n, subsample_size=b) as idx:
            xb = xa[idx]
            z = sample(
                "z", dist.Normal(0.0, 1.0).expand((b, cfg.latent_dim))
                .to_event(2)
            )
            mu = dec.apply(dec_params, z)
            sample("obs", dist.Normal(mu, sigma_x).to_event(2), obs=xb)

    def guide_init(key):
        return enc.init(key)

    def guide_sample(params, key, sample_shape, stop_gradient_q, ctx):
        sub = (ctx or {}).get("subsample") or {}
        idx = sub.get("data__idx", jnp.arange(b))
        margs = (ctx or {}).get("model_args")
        xa = margs[0] if margs else x
        xb = xa[idx]
        mu, log_sig = enc.apply(params, xb)            # (b, dz)
        eps = jax.random.normal(
            key, tuple(sample_shape) + mu.shape, mu.dtype
        )
        z = mu + jnp.exp(log_sig) * eps
        if stop_gradient_q:
            mu_q, log_sig_q = jax.lax.stop_gradient((mu, log_sig))
        else:
            mu_q, log_sig_q = mu, log_sig
        zz = (z - mu_q) * jnp.exp(-log_sig_q)
        logq = jnp.sum(-0.5 * zz * zz - log_sig_q - 0.5 * _LOG_2PI,
                       axis=(-2, -1))
        # match the model-side N/B plate scaling (unbiased mini-batch ELBO)
        return {"z": z}, scale * logq

    return model, NeuralGuide(guide_init, guide_sample), dec, enc


def run_svi(cfg: Config, key=None, data_sharding=None):
    key = key if key is not None else jax.random.PRNGKey(cfg.seed)
    x = make_data(cfg)
    if data_sharding is not None:
        x = jax.device_put(x, data_sharding)
    model, guide, dec, enc = make_model_and_guide(cfg, x)
    svi = SVI(model, guide, optax.adam(cfg.lr), model_args=(x,))

    if cfg.bench:
        state = svi.init(key)
        _, dt = timed_steps(
            lambda s: svi.run(key, cfg.steps, state=s, model_args=(x,)),
            state,
        )
        bench_line("elbo_steps_per_s", cfg.steps / dt, "steps/s",
                   model="dlgm", n=cfg.num_data, batch=cfg.batch_size)
    res = svi.run(key, cfg.steps, model_args=(x,))
    mp = svi.model_params(res.params)
    return {
        "svi": svi,
        "result": res,
        "x": x,
        "decoder": dec,
        "encoder": enc,
        "decoder_params": mp["decoder"],
        "sigma_x": float(mp["sigma_x"]),
        "final_elbo": -float(res.losses[-1]),
        "losses": np.asarray(res.losses),
        "guide_params": svi.guide_params(res.params),
    }


def local_posterior_model(cfg: Config, dec, dec_params, sigma_x, x_batch):
    """The model over the local latents z of ``x_batch`` for a fixed
    decoder."""
    nb = int(x_batch.shape[0])

    def model():
        z = sample(
            "z", dist.Normal(0.0, 1.0).expand((nb, cfg.latent_dim))
            .to_event(2)
        )
        mu = dec.apply(dec_params, z)
        sample("obs", dist.Normal(mu, sigma_x).to_event(2), obs=x_batch)

    return model


def local_posterior_mcmc(cfg: Config, dec, dec_params, sigma_x, x_batch,
                         key, chain_sharding=None, shared_adapt=None):
    """NUTS over the local latents z for a fixed decoder — the
    1024-chain workload of configs[4]."""
    if shared_adapt is None:
        # pooled adaptation is the right default once chains are many
        shared_adapt = cfg.num_chains >= 64
    mcmc = MCMC(model=local_posterior_model(cfg, dec, dec_params, sigma_x,
                                            x_batch),
                num_warmup=cfg.num_warmup,
                num_samples=cfg.num_samples, num_chains=cfg.num_chains,
                chain_sharding=chain_sharding, init_step_size=0.2,
                shared_adapt=shared_adapt)
    return mcmc, mcmc.run(key)


def run(cfg: Config, key=None):
    if cfg.smoke:
        cfg = dataclasses.replace(
            cfg, num_data=512, data_dim=8, latent_dim=3, hidden=16,
            batch_size=64, steps=300, num_chains=8, num_warmup=100,
            num_samples=100, nuts_batch=2,
        )
    out = run_svi(cfg, key)
    # reconstruction check
    x = out["x"]
    mu_z, _ = out["encoder"].apply(out["guide_params"], x[:256])
    recon = out["decoder"].apply(out["decoder_params"], mu_z)
    out["recon_rmse"] = float(jnp.sqrt(jnp.mean((recon - x[:256]) ** 2)))

    # NUTS variant on a small batch
    kb = jax.random.PRNGKey(cfg.seed + 1)
    _, mres = local_posterior_mcmc(
        cfg, out["decoder"], out["decoder_params"], out["sigma_x"],
        x[:cfg.nuts_batch], kb,
    )
    z = mres.samples["z"]
    z2 = z.reshape(z.shape[0], z.shape[1], -1)
    summ = diag.ess(z2)
    out["nuts_min_ess"] = float(jnp.min(summ))
    out["nuts_divergences"] = int(mres.extra["diverging"].sum())
    return out


def main(argv=None):
    cfg = parse_config(Config, argv)
    print(dump_config(cfg))
    out = run(cfg)
    print(f"final ELBO = {out['final_elbo']:.1f}")
    print(f"sigma_x = {out['sigma_x']:.3f} (true 0.3)")
    print(f"recon RMSE = {out['recon_rmse']:.3f}")
    print(f"NUTS z-posterior: min ESS = {out['nuts_min_ess']:.0f}, "
          f"divergences = {out['nuts_divergences']}")


if __name__ == "__main__":
    main()
