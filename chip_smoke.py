"""Chip smoke test: drive the main paths once on one GPU and check them.

    python3 chip_smoke.py            # one card: phases P4, P1, P2, P3
    python3 chip_smoke.py --four     # four cards: the sharded paths only

Phases (one card):

* P4 — ``pytest -m gpu`` in a child process, run BEFORE this process
  imports JAX: two JAX processes cannot share one card.
* P1 — flagship DLGM SVI at the harness width (65,536 x 128 data, latent
  32, hidden 256, batch 1,024) through ``SVI.run``, plus one ELBO and its
  gradient on the card (default precision and HIGHEST) against CPU float32.
* P2 — DLGM local-posterior NUTS at the harness width (1,024 chains, a
  64-row batch: 512 latent dimensions per chain) through
  ``MCMC(shared_adapt=True)``, with the potential checked against CPU
  float32 and an R-hat / divergence gate.
* P3 — GMM SMC at the harness shape (8,192 particles, N=2,000, D=2, K=3):
  the compiled gmm_loglik kernel against its reference, the per-evaluation
  and per-``SMC.run`` times of kernel and XLA, and the predictive gap.

``--four`` instead checks each sharded path against its one-card or
unsharded result: DP-SVI over a ``data`` mesh, sharded-chain NUTS over a
``chain`` mesh, particle-sharded systematic resampling, and item-sharded
dense matrix factorisation.

Nothing falls back to the CPU: without a GPU the script says why and exits
non-zero.  Any failed phase makes it exit non-zero.  Rates are printed
with the card's name and power limit; they are information, not claims.
The last stdout line, on success only, is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))


class GateFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise GateFailure(msg)


def _say(*parts):
    print(*parts, flush=True)


def card_label():
    """``nvidia-smi``'s name and power limit of the card(s), read by a
    child process that stays off JAX; None when no GPU answers."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, f"nvidia-smi did not run: {e}"
    if proc.returncode != 0 or not proc.stdout.strip():
        return None, f"nvidia-smi failed: {proc.stderr.strip()[-300:]}"
    return proc.stdout.strip(), None


def _rel(a, b):
    """Relative error of ``a`` against ``b``: L2 norm over a pytree."""
    import jax
    import numpy as np

    la = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(a)]
    lb = [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(b)]
    num = np.sqrt(sum(float(np.sum((x - y) ** 2)) for x, y in zip(la, lb)))
    den = np.sqrt(sum(float(np.sum(y ** 2)) for y in lb))
    return num / max(den, 1e-30)


def _scaled_max(a, b):
    """max |a - b| / (1 + max |b|), the kernel-parity measure."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b))))


def _time(fn, *args, reps):
    """Mean seconds per call of a warmed-up ``fn``."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------------------
# P1: DLGM SVI at the harness width
# ---------------------------------------------------------------------------

P1_LOSS_MARGIN = 0.05     # mean(last 100) <= (1 - margin) * mean(first 100)
P1_VALUE_TOL = 1e-5       # HIGHEST on the card vs CPU float32: ELBO value
P1_GRAD_TOL = 1e-4        # ... and its gradient (relative L2 norm)


def phase_svi(label, num_data=65_536, data_dim=128, latent_dim=32,
              hidden=256, batch_size=1024, steps=2000):
    import jax
    import numpy as np
    import optax

    from bayesic_tpu.core.precision import exact
    from bayesic_tpu.infer.svi import SVI
    from bayesic_tpu.infer.svi.elbo import draw_subsample
    from bayesic_tpu.models import dlgm

    cfg = dlgm.Config(num_data=num_data, data_dim=data_dim,
                      latent_dim=latent_dim, hidden=hidden,
                      batch_size=batch_size)
    x = dlgm.make_data(cfg)
    model, guide, _, _ = dlgm.make_model_and_guide(cfg, x)
    svi = SVI(model, guide, optax.adam(cfg.lr), model_args=(x,))

    t0 = time.perf_counter()
    jax.block_until_ready(svi.run(jax.random.PRNGKey(0), steps,
                                  model_args=(x,)).losses)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = svi.run(jax.random.PRNGKey(1), steps, model_args=(x,))
    losses = np.asarray(jax.block_until_ready(res.losses))
    dt = time.perf_counter() - t0
    w = min(100, steps // 4)
    first, last = float(losses[:w].mean()), float(losses[-w:].mean())
    _say(f"P1 dlgm svi: {steps} steps, compile+run {t_first:.3f} s, "
         f"run {dt:.4f} s = {steps / dt:.1f} steps/s on {label}; "
         f"loss first-{w} mean {first:.1f}, last-{w} mean {last:.1f}")
    check(np.isfinite(losses).all(), "P1: non-finite SVI loss")
    check(last <= first - P1_LOSS_MARGIN * abs(first),
          f"P1: loss did not improve by {P1_LOSS_MARGIN:.0%}")

    # one ELBO + gradient at fixed params and key, three ways
    def neg_elbo(params, key, xa, svi=svi):
        gp, mp = svi._split_params(params)
        return -svi.elbo(gp, key, subsample=draw_subsample(svi.info, key),
                         model_args=(xa,), model_params=mp)

    key = jax.random.PRNGKey(7)
    vg_default = jax.jit(jax.value_and_grad(neg_elbo))(res.params, key, x)
    vg_highest = jax.jit(exact(jax.value_and_grad(neg_elbo)))(
        res.params, key, x)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        x_c = jax.device_put(x, cpu)
        model_c, guide_c, _, _ = dlgm.make_model_and_guide(cfg, x_c)
        svi_c = SVI(model_c, guide_c, optax.adam(cfg.lr),
                    model_args=(x_c,))

        def neg_elbo_c(params, key, xa):
            return neg_elbo(params, key, xa, svi=svi_c)

        vg_cpu = jax.jit(jax.value_and_grad(neg_elbo_c))(
            jax.device_put(res.params, cpu), jax.device_put(key, cpu), x_c)
    out = {"steps_per_s": steps / dt, "loss_first": first,
           "loss_last": last}
    for name, vg in (("default", vg_default), ("highest", vg_highest)):
        out[f"value_rel_{name}"] = _rel(vg[0], vg_cpu[0])
        out[f"grad_rel_{name}"] = _rel(vg[1], vg_cpu[1])
        _say(f"P1 elbo on card ({name} precision) vs CPU float32: value "
             f"rel err {out[f'value_rel_{name}']:.3e}, gradient rel err "
             f"{out[f'grad_rel_{name}']:.3e}")
    check(out["value_rel_highest"] <= P1_VALUE_TOL,
          f"P1: HIGHEST ELBO value off CPU by > {P1_VALUE_TOL}")
    check(out["grad_rel_highest"] <= P1_GRAD_TOL,
          f"P1: HIGHEST ELBO gradient off CPU by > {P1_GRAD_TOL}")
    return out


# ---------------------------------------------------------------------------
# P2: DLGM local-posterior NUTS at the harness width
# ---------------------------------------------------------------------------

P2_RHAT_MAX = 1.05
P2_DIVERGENCE_SHARE = 0.01   # divergent transitions / all sampled ones
P2_VALUE_TOL = 1e-5          # pinned potential on the card vs CPU float32
P2_GRAD_TOL = 1e-4


def phase_nuts(label, num_chains=1024, rows=64, svi_steps=200,
               num_warmup=200, num_samples=200):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bayesic_tpu.core.precision import exact
    from bayesic_tpu.infer.mcmc import MCMC
    from bayesic_tpu.models import dlgm
    from bayesic_tpu.utils import diagnostics as diag

    small = dlgm.run_svi(dlgm.Config(num_data=2048, data_dim=32,
                                     latent_dim=8, hidden=64,
                                     batch_size=256, steps=svi_steps))
    cfg = dlgm.Config(num_data=2048, data_dim=32, latent_dim=8, hidden=64,
                      num_chains=num_chains, num_warmup=num_warmup,
                      num_samples=num_samples)
    args = (small["decoder"], small["decoder_params"], small["sigma_x"],
            small["x"][:rows])
    t0 = time.perf_counter()
    mcmc, res = dlgm.local_posterior_mcmc(cfg, *args, jax.random.PRNGKey(2),
                                          shared_adapt=True)
    jax.block_until_ready(res.unconstrained)
    t_first = time.perf_counter() - t0

    @jax.jit
    def summarize(qs, divs):
        return (jnp.min(diag.ess(qs)), jnp.max(diag.split_rhat(qs)),
                jnp.sum(divs))

    summarize(res.unconstrained, res.extra["diverging"])
    t0 = time.perf_counter()
    res = mcmc.run(jax.random.PRNGKey(3))
    min_ess, max_rhat, divs = (float(v) for v in summarize(
        res.unconstrained, res.extra["diverging"]))
    dt = time.perf_counter() - t0
    n_trans = num_chains * num_samples
    _say(f"P2 dlgm nuts: {num_chains} chains x {mcmc.dim} dims, "
         f"{num_warmup}+{num_samples} transitions, compile+run "
         f"{t_first:.2f} s, run {dt:.3f} s; min-ESS {min_ess:.1f} = "
         f"{min_ess / dt:.1f} ESS/s on {label}; max R-hat "
         f"{max_rhat:.4f}; divergences {int(divs)}/{n_trans}; step size "
         f"{float(res.extra['step_size']):.4f}")
    check(np.isfinite(np.asarray(res.unconstrained)).all(),
          "P2: non-finite samples")
    check(max_rhat <= P2_RHAT_MAX, f"P2: max R-hat {max_rhat:.4f} > "
          f"{P2_RHAT_MAX}")
    check(divs < P2_DIVERGENCE_SHARE * n_trans,
          f"P2: {int(divs)} divergences >= {P2_DIVERGENCE_SHARE:.0%} of "
          "transitions")

    # the potential and its gradient, pinned as MCMC's programs pin it,
    # vs CPU float32 at a draw
    q = res.unconstrained[0, -1]
    pe, g = jax.jit(exact(mcmc._potential_and_grad))(q)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        dec_p, x_b = jax.device_put((args[1], args[3]), cpu)
        mcmc_c = MCMC(model=dlgm.local_posterior_model(
            cfg, args[0], dec_p, args[2], x_b), num_chains=1)
        pe_c, g_c = jax.jit(mcmc_c._potential_and_grad)(
            jax.device_put(q, cpu))
    value_rel, grad_rel = _rel(pe, pe_c), _rel(g, g_c)
    _say(f"P2 potential on card (pinned) vs CPU float32: value rel err "
         f"{value_rel:.3e}, gradient rel err {grad_rel:.3e}")
    check(value_rel <= P2_VALUE_TOL, f"P2: potential off CPU by > "
          f"{P2_VALUE_TOL}")
    check(grad_rel <= P2_GRAD_TOL, f"P2: potential gradient off CPU by > "
          f"{P2_GRAD_TOL}")
    return {"min_ess": min_ess, "ess_per_s": min_ess / dt,
            "max_rhat": max_rhat, "divergences": int(divs), "wall_s": dt,
            "value_rel": value_rel, "grad_rel": grad_rel}


# ---------------------------------------------------------------------------
# P3: GMM SMC at the harness shape
# ---------------------------------------------------------------------------

P3_KERNEL_TOL = 1e-5   # max|kernel - reference| / (1 + max|reference|)
P3_GAP_MAX = 0.3       # tests/test_models.py::test_gmm_smc_predictive_...


def phase_gmm(label, num_particles=8192, num_data=2000, eval_reps=50,
              smc_rounds=2, interpret=False):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bayesic_tpu.core.precision import exact
    from bayesic_tpu.models import gmm
    from bayesic_tpu.ops import gmm_logprob as g

    cfg = gmm.Config(num_particles=num_particles, num_data=num_data)
    x, truth = gmm.make_data(cfg)
    k, d, p = cfg.num_components, cfg.data_dim, num_particles
    ks = jax.random.split(jax.random.PRNGKey(11), 3)
    lw = jax.nn.log_softmax(jax.random.normal(ks[0], (p, k)), -1)
    mus = 4.0 * jax.random.normal(ks[1], (p, k, d))
    sig = jnp.exp(0.3 * jax.random.normal(ks[2], (p, k)))
    params = (lw, mus, sig)

    ref_vg = jax.jit(exact(
        lambda *a: g._reference_value_and_grad(x, *a)))(*params)
    kern_v = jax.jit(lambda *a: g.gmm_loglik(x, *a, interpret))
    kern_g = jax.jit(jax.grad(
        lambda *a: jnp.sum(g.gmm_loglik(x, *a, interpret)),
        argnums=(0, 1, 2)))
    kern_vg = jax.jit(
        lambda *a: g.gmm_loglik_grad(x, *a, interpret=interpret))
    errs = {"value": _scaled_max(kern_v(*params), ref_vg[0])}
    for name, got, ref in zip(("dlogw", "dmus", "dsig"), kern_g(*params),
                              ref_vg[1:]):
        errs[f"grad_{name}"] = _scaled_max(got, ref)
    for name, got, ref in zip(("value", "dlogw", "dmus", "dsig"),
                              kern_vg(*params), ref_vg):
        errs[f"vg_{name}"] = _scaled_max(got, ref)
    worst = max(errs.values())
    _say(f"P3 gmm_loglik kernel vs reference (HIGHEST) at P={p}, "
         f"N={num_data}, K={k}, D={d}: worst scaled err {worst:.3e} "
         + json.dumps({n: float(f"{e:.3e}") for n, e in errs.items()}))
    check(worst <= P3_KERNEL_TOL, f"P3: kernel off reference by > "
          f"{P3_KERNEL_TOL}")

    xla_vg = jax.jit(lambda *a: g._reference_value_and_grad(x, *a))
    t_kernel = _time(kern_vg, *params, reps=eval_reps)
    t_xla = _time(xla_vg, *params, reps=eval_reps)
    _say(f"P3 one value+grad evaluation: kernel {t_kernel * 1e3:.4f} ms, "
         f"XLA {t_xla * 1e3:.4f} ms on {label}")

    # three ways through SMC.run: the model's own log-density ("xla"), the
    # plain reference behind the batched hooks ("hooks"), and the kernel
    # behind the same hooks ("kernel"); kernel vs hooks is the kernel's own
    # gain, hooks vs xla the hooks' (no vmap-of-replay of the mixture)
    modes = {"xla": dict(kernel=False),
             "hooks": dict(kernel=True, reference=True),
             "kernel": dict(kernel=True, interpret=interpret)}
    runs = {}
    for mode, kw in modes.items():
        smc = gmm.make_smc(cfg, x, **kw)
        t0 = time.perf_counter()
        jax.block_until_ready(smc.run(jax.random.PRNGKey(0),
                                      stage_chunk=24).log_evidence)
        runs[mode] = {"smc": smc, "compile_s": time.perf_counter() - t0,
                      "walls": [], "stages": [], "logz": []}
    order = (tuple(modes) + tuple(reversed(modes))) * smc_rounds
    for i, mode in enumerate(order):
        r = runs[mode]
        t0 = time.perf_counter()
        res = r["smc"].run(jax.random.PRNGKey(100 + i), stage_chunk=24)
        jax.block_until_ready(res.log_evidence)
        r["walls"].append(time.perf_counter() - t0)
        r["stages"].append(int(res.num_stages))
        r["logz"].append(float(res.log_evidence))
        r["res"] = res
    out = {"eval_ms_kernel": t_kernel * 1e3, "eval_ms_xla": t_xla * 1e3,
           "kernel_worst_err": worst}
    for mode, r in runs.items():
        # particle-stages over wall time, summed over the runs
        rate = p * sum(r["stages"]) / sum(r["walls"])
        gap = gmm._true_loglik(x, truth) - gmm.predictive_loglik(
            r["res"], x, cfg)
        out[f"smc_{mode}"] = {"walls_s": r["walls"], "stages": r["stages"],
                              "particle_stages_per_s": rate,
                              "log_evidence": r["logz"], "gap": gap}
        _say(f"P3 SMC.run ({mode}): compile+run {r['compile_s']:.2f} s, "
             f"runs {[round(w, 4) for w in r['walls']]} s, stages "
             f"{r['stages']}, {rate:.1f} particle-stages/s on {label}; "
             f"logZ {[round(z, 2) for z in r['logz']]}; predictive gap "
             f"{gap:.4f}")
        check(np.isfinite(r["logz"]).all(), f"P3: non-finite logZ ({mode})")
        check(abs(gap) < P3_GAP_MAX, f"P3: predictive gap {gap:.3f} "
              f"({mode}) >= {P3_GAP_MAX}")
    rate = {m: out[f"smc_{m}"]["particle_stages_per_s"] for m in modes}
    _say(f"P3 SMC.run gains on {label}: kernel over hooks "
         f"{rate['kernel'] / rate['hooks']:.3f}x, hooks over xla "
         f"{rate['hooks'] / rate['xla']:.3f}x, kernel over xla "
         f"{rate['kernel'] / rate['xla']:.3f}x")
    return out


# ---------------------------------------------------------------------------
# P4: card-only tests in a child process
# ---------------------------------------------------------------------------

def phase_gpu_tests():
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "tests"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    tail = "\n".join(proc.stdout.strip().splitlines()[-15:])
    _say(f"P4 pytest -m gpu: rc {proc.returncode} in "
         f"{time.perf_counter() - t0:.1f} s\n{tail}")
    check(proc.returncode == 0, f"P4: card-only tests failed (rc "
          f"{proc.returncode}): {proc.stderr.strip()[-500:]}")
    check(" passed" in tail and "skipped" not in tail,
          "P4: card-only tests did not all run and pass")


# ---------------------------------------------------------------------------
# --four: each sharded path against its one-card / unsharded result
# ---------------------------------------------------------------------------

FOUR_SVI_TOL = 1e-4      # per-step loss, relative, HIGHEST precision
FOUR_NUTS_Z = 5.0        # posterior mean, in MC standard errors (per dim)
FOUR_NUTS_SD = 0.05      # posterior sd, relative
FOUR_NUTS_STEP_TOL = 1e-4  # first transition, |sharded - unsharded| / (1+|q|)
FOUR_NUTS_STEP_SHARE = 0.99  # share of chains within that tolerance
FOUR_MF_TOL = 1e-5       # dense MF loss, relative, HIGHEST precision


def four_dp_svi(devices, num_data=65_536, data_dim=128, latent_dim=32,
                hidden=256, batch_per_device=1024, steps=20):
    """DLGM DP-SVI steps over a ``data`` mesh vs the same steps on one
    card.  Both run at HIGHEST precision so the check is of the sharding,
    not of TF32 rounding in differently tiled products."""
    import jax
    import numpy as np
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bayesic_tpu.core.precision import exact
    from bayesic_tpu.infer.svi import SVI
    from bayesic_tpu.models import dlgm
    from bayesic_tpu.parallel import make_mesh

    n = len(devices)
    cfg = dlgm.Config(num_data=num_data, data_dim=data_dim,
                      latent_dim=latent_dim, hidden=hidden,
                      batch_size=batch_per_device * n)
    x = dlgm.make_data(cfg)
    model, guide, _, _ = dlgm.make_model_and_guide(cfg, x)
    svi = SVI(model, guide, optax.adam(cfg.lr), model_args=(x,))

    def block(state, xa):
        return jax.lax.scan(lambda c, _: svi.step(c, model_args=(xa,)),
                            state, None, length=steps)

    run = jax.jit(exact(block))
    state0 = svi.init(jax.random.PRNGKey(0))
    one = jax.device_put((state0, x), devices[0])
    _, loss_1 = run(*one)
    mesh = make_mesh({"data": n}, devices=devices)
    x_sh = jax.device_put(x, NamedSharding(mesh, P("data")))
    state_sh = jax.device_put(state0, NamedSharding(mesh, P()))
    _, loss_n = run(state_sh, x_sh)
    loss_1, loss_n = np.asarray(loss_1), np.asarray(loss_n)
    rel = float(np.max(np.abs(loss_n - loss_1) / np.abs(loss_1)))
    _say(f"4x dp-svi: {steps} DLGM steps, batch {cfg.batch_size} over "
         f"{n} cards vs one card: max per-step loss rel diff {rel:.3e}")
    check(np.isfinite(loss_n).all(), "4x dp-svi: non-finite loss")
    check(rel <= FOUR_SVI_TOL, f"4x dp-svi: sharded loss off by > "
          f"{FOUR_SVI_TOL}")
    return {"loss_rel": rel}


def four_chain_nuts(devices, num_chains=4096, dim=64, num_warmup=200,
                    num_samples=200):
    """Sharded-chain NUTS over a ``chain`` mesh vs unsharded, on a model
    with an analytic Gaussian posterior: z_i ~ N(0, s_i^2), 0.5 ~
    N(sum z, 1).  Chains are keyed by logical index, so both runs start
    from the same states and draw the same random numbers.  On a GPU the
    order of a reduction can depend on the per-device batch, so energies
    differ in the last bits and chaotic trajectories part over a long run.
    So the check is per chain where it can be and distributional where it
    must be: the initial states are bit-equal; after one transition each
    chain sits where its unsharded twin does to float32 accuracy (a rare
    tree-building choice flipped by a last-bit difference may send a few
    chains elsewhere); no two sharded chains are identical (a chain keyed
    by device instead of logical index would repeat); and both full runs
    sample the analytic posterior within Monte Carlo error."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bayesic_tpu import dist
    from bayesic_tpu.core import sample
    from bayesic_tpu.infer.mcmc import MCMC
    from bayesic_tpu.parallel import make_mesh
    from bayesic_tpu.utils import diagnostics as diag

    scale = np.linspace(0.5, 2.0, dim)

    def model():
        z = sample("z", dist.Normal(0.0, jnp.asarray(scale)).to_event(1))
        sample("obs", dist.Normal(jnp.sum(z), 1.0), obs=jnp.asarray(0.5))

    # posterior precision diag(1/s^2) + 1 1^T
    cov = np.linalg.inv(np.diag(scale ** -2.0) + 1.0)
    mean_true = cov @ np.full(dim, 0.5)
    sd_true = np.sqrt(np.diag(cov))
    key = jax.random.PRNGKey(5)

    def run(sharding):
        mcmc = MCMC(model=model, num_warmup=num_warmup,
                    num_samples=num_samples, num_chains=num_chains,
                    chain_sharding=sharding)
        # the run's own init and first warmup transition (run() splits
        # its key the same way)
        key_init, key_warm, _ = jax.random.split(key, 3)
        carry0 = mcmc._initial_carry(key_init)
        warm, _ = mcmc._build_steps()
        carry1 = jax.jit(warm)(key_warm, carry0, jnp.asarray(0))[0]
        steps = [np.asarray(a) for a in (carry0.state.q, carry0.state.pe,
                                         carry1.state.q)]
        qs = mcmc.run(key).unconstrained
        stats = jax.jit(lambda a: (jnp.mean(a, (0, 1)), jnp.std(a, (0, 1)),
                                   diag.ess(a), diag.split_rhat(a)))(qs)
        return steps, np.asarray(qs), [np.asarray(v, np.float64)
                                       for v in stats]

    with jax.default_device(devices[0]):
        ref_steps, ref, ref_stats = run(None)
    mesh = make_mesh({"chain": len(devices)}, devices=devices)
    got_steps, got, got_stats = run(NamedSharding(mesh, P("chain")))
    q1_ref, q1_got = ref_steps[2], got_steps[2]
    err = np.max(np.abs(q1_got - q1_ref) / (1.0 + np.abs(q1_ref)), axis=1)
    out = {"init_bit_equal": bool(np.array_equal(got_steps[0], ref_steps[0])
                                  and np.array_equal(got_steps[1],
                                                     ref_steps[1])),
           "step1_share_within_tol": float(np.mean(err <= FOUR_NUTS_STEP_TOL)),
           "step1_max_err": float(err.max()),
           "step1_median_err": float(np.median(err)),
           "distinct_chains": min(
               np.unique(q1_got, axis=0).shape[0],
               np.unique(got[:, -1, :], axis=0).shape[0]),
           "bit_identical": bool(np.array_equal(got, ref)),
           "chains_identical": int(np.all(got == ref, axis=(1, 2)).sum())}
    for name, (mean, sd, ess, rhat) in (("unsharded", ref_stats),
                                        ("sharded", got_stats)):
        z = np.abs(mean - mean_true) / (sd_true / np.sqrt(ess))
        out[name] = {"max_mean_z": float(z.max()),
                     "max_sd_rel_err": float(np.abs(sd / sd_true - 1).max()),
                     "max_rhat": float(rhat.max()),
                     "min_ess": float(ess.min())}
    _say(f"4x chain-sharded nuts: {num_chains} chains x {dim} dims over "
         f"{len(devices)} cards vs unsharded: "
         + json.dumps({k: v for k, v in out.items()
                       if k not in ("unsharded", "sharded")})
         + "; vs the analytic posterior "
         + json.dumps({k: out[k] for k in ("unsharded", "sharded")}))
    check(out["init_bit_equal"], "4x nuts: initial states differ")
    check(out["step1_share_within_tol"] >= FOUR_NUTS_STEP_SHARE,
          f"4x nuts: only {out['step1_share_within_tol']:.4f} of chains "
          f"within {FOUR_NUTS_STEP_TOL} of unsharded after one transition")
    check(out["distinct_chains"] == num_chains,
          "4x nuts: sharded chains repeat one another")
    for name in ("unsharded", "sharded"):
        r = out[name]
        check(r["max_rhat"] <= P2_RHAT_MAX, f"4x nuts: {name} R-hat "
              f"{r['max_rhat']:.4f}")
        check(r["max_mean_z"] <= FOUR_NUTS_Z, f"4x nuts: {name} posterior "
              f"mean {r['max_mean_z']:.2f} MC standard errors off")
        check(r["max_sd_rel_err"] <= FOUR_NUTS_SD, f"4x nuts: {name} "
              f"posterior sd off by {r['max_sd_rel_err']:.3f}")
    return out


def four_resample(devices, num_particles=1 << 20, dim=16):
    """Particle-sharded systematic resampling (explicit shard_map) vs the
    global resampler.  The routed rows must be exactly the ancestors'
    rows, and both must keep systematic resampling's guarantee: particle
    i gets floor(N w_i) or ceil(N w_i) offspring.  Ancestor indices
    themselves differ where a stratified position falls within float32
    rounding of a cumulative-weight boundary (the two prefix sums add in
    different orders), so each particle's offspring count may differ by
    one.  At 2^20 particles float32 still resolves the 1/N spacing; far
    beyond it neither resampler keeps the floor/ceil guarantee (an open
    defect, listed in ROADMAP.md)."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bayesic_tpu.parallel import make_mesh
    from bayesic_tpu.parallel.resample import (
        systematic_ancestors,
        systematic_resample_shard_map,
    )

    mesh = make_mesh({"particle": len(devices)}, devices=devices)
    sh = NamedSharding(mesh, P("particle"))
    lw = jax.random.normal(jax.random.PRNGKey(2), (num_particles,))
    particles = jax.random.normal(jax.random.PRNGKey(3),
                                  (num_particles, dim))
    fn = jax.jit(jax.shard_map(
        systematic_resample_shard_map("particle"), mesh=mesh,
        in_specs=(P(), P("particle"), P("particle")),
        out_specs=(P("particle"), P("particle"))))
    out, anc = fn(jax.random.PRNGKey(4), jax.device_put(lw, sh),
                  jax.device_put(particles, sh))
    with jax.default_device(devices[0]):
        ref = np.asarray(jax.jit(systematic_ancestors)(
            jax.random.PRNGKey(4), jax.device_put(lw, devices[0])))
    anc, out = np.asarray(anc), np.asarray(out)
    routed = bool(np.array_equal(out, np.asarray(particles)[anc]))
    lw64 = np.asarray(lw, np.float64)
    nw = num_particles * np.exp(lw64 - lw64.max()) / np.exp(
        lw64 - lw64.max()).sum()
    counts = {name: np.bincount(a, minlength=num_particles)
              for name, a in (("sharded", anc), ("global", ref))}
    excess = {name: int(np.max(np.maximum(np.floor(nw) - c,
                                          c - np.ceil(nw))))
              for name, c in counts.items()}
    count_diff = int(np.abs(counts["sharded"] - counts["global"]).max())
    _say(f"4x resample: {num_particles} particles over {len(devices)} "
         f"cards vs global: rows routed exactly {routed}; ancestor "
         f"mismatch share {float(np.mean(anc != ref)):.2e}; max offspring "
         f"count difference {count_diff}; floor/ceil excess {excess}")
    check(routed, "4x resample: routed rows differ from ancestors' rows")
    check(bool(np.all(np.diff(anc) >= 0)), "4x resample: unsorted")
    check(max(excess.values()) == 0,
          "4x resample: offspring count outside floor/ceil(N w)")
    check(count_diff <= 1, "4x resample: offspring counts differ by > 1")
    return {"count_diff": count_diff}


def four_dense_mf(devices, num_users=4096, num_items=4096, num_factors=16,
                  num_ratings=2_000_000):
    """Item-sharded dense MF loss vs the unsharded closed form."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bayesic_tpu.core.precision import exact
    from bayesic_tpu.models import matrix_fact as mfm
    from bayesic_tpu.parallel import make_mesh

    cfg = mfm.Config(num_users=num_users, num_items=num_items,
                     num_factors=num_factors, num_ratings=num_ratings)
    users, items, ratings, _ = mfm.make_data(cfg)
    cnt, rsum, sqsum, nr = mfm.dense_stats(users, items, ratings,
                                           num_users, num_items)
    params = mfm.dense_init(cfg)
    mesh = make_mesh({"items": len(devices)}, devices=devices)
    params_sh = jax.tree_util.tree_map(
        lambda leaf, s: jax.device_put(leaf, NamedSharding(mesh, s)),
        params, mfm.dense_param_specs(mesh),
        is_leaf=lambda a: isinstance(a, jax.Array))
    cols = NamedSharding(mesh, P(None, "items"))
    loss_sh = mfm.dense_neg_elbo_sharded(mesh, sqsum, nr, cfg.noise)
    got = float(jax.jit(exact(loss_sh))(
        params_sh, jax.device_put(cnt, cols), jax.device_put(rsum, cols)))
    one = jax.device_put((params, cnt, rsum), devices[0])
    ref = float(jax.jit(exact(
        lambda p_, c_, r_: mfm.dense_neg_elbo(p_, c_, r_, sqsum, float(nr),
                                              cfg.noise)))(*one))
    rel = abs(got - ref) / abs(ref)
    _say(f"4x dense mf: {num_users}x{num_items} cells item-sharded over "
         f"{len(devices)} cards vs unsharded: loss {got:.6e} vs "
         f"{ref:.6e}, rel diff {rel:.3e}")
    check(rel <= FOUR_MF_TOL, f"4x dense mf: sharded loss off by > "
          f"{FOUR_MF_TOL}")
    return {"loss_rel": rel}


FOUR_CHECKS = (four_dp_svi, four_chain_nuts, four_resample, four_dense_mf)


# ---------------------------------------------------------------------------

def _run_phases(phases):
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            _say(f"{name}: ok in {time.perf_counter() - t0:.1f} s")
        except Exception as e:  # noqa: BLE001 — reported, and fails the run
            failed.append(name)
            _say(f"{name}: FAILED in {time.perf_counter() - t0:.1f} s: "
                 f"{type(e).__name__}: {e}")
            traceback.print_exc()
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="check the sharded paths on four cards, and "
                         "nothing else")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "bayesic_tpu")):
        _say("chip_smoke: run me from a checkout of the repository "
             f"(no bayesic_tpu/ beside {__file__})")
        return 2
    label, why = card_label()
    if label is None:
        _say(f"chip_smoke: no GPU: {why}")
        return 1
    _say(f"card: {label}")

    failed = []
    if not args.four:
        # before this process imports JAX: one process per card
        failed += _run_phases([("P4", phase_gpu_tests)])

    # keep the CPU backend reachable for the float32 references
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, HERE)
    import jax

    from benchmarks.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    try:
        devices = jax.devices()
    except RuntimeError as e:
        _say(f"chip_smoke: JAX found no accelerator: {e}")
        return 1
    dev = devices[0]
    if dev.platform != "gpu":
        _say(f"chip_smoke: JAX's default device is {dev.platform!r}, not a "
             "GPU; refusing to measure the CPU")
        return 1
    _say(f"jax {jax.__version__}; devices {len(devices)} x "
         f"{dev.device_kind}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
         f"compile cache {cache}")

    if args.four:
        if len(devices) < 4:
            _say(f"chip_smoke --four: needs 4 GPUs, found {len(devices)}")
            return 1
        four = devices[:4]
        failed += _run_phases([(f.__name__, lambda f=f: f(four))
                               for f in FOUR_CHECKS])
    else:
        failed += _run_phases([
            ("P1", lambda: phase_svi(label)),
            ("P2", lambda: phase_nuts(label)),
            ("P3", lambda: phase_gmm(label)),
        ])
    if failed:
        _say(f"chip_smoke: FAILED phases {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
