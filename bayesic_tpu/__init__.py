"""bayesic_tpu — a probabilistic-programming inference engine in JAX.

Built from scratch against the capability surface of mjwillson/Bayesic
(see SURVEY.md; the reference source was never observable — /root/reference
was empty — so parity targets come from BASELINE.json's north_star/configs).

Layering (SURVEY.md §1b):
  dist/      distributions + transforms            (C1, C2)
  core/      model DSL + joint log-prob compiler   (C3, C4)
  infer/     SVI, HMC/NUTS, SMC backends           (C5-C10)
  parallel/  mesh, shardings, collectives, launch  (C11-C13, C15)
  ops/       hand-written kernels + references    (C14)
  models/    the five reference example models     (C16-C20)
  utils/     diagnostics, checkpoint, config, logs (C21, C23, aux)
"""

__version__ = "0.1.0"

from . import dist  # noqa: F401
from .core import (  # noqa: F401
    deterministic,
    factor,
    param,
    plate,
    sample,
)


def __getattr__(name):
    # lazy heavy imports so `import bayesic_tpu` stays cheap
    if name == "SVI":
        from .infer.svi import SVI
        return SVI
    if name == "MCMC":
        from .infer.mcmc import MCMC
        return MCMC
    if name == "SMC":
        from .infer.smc import SMC
        return SMC
    if name == "Predictive":
        from .infer.predictive import Predictive
        return Predictive
    if name == "log_likelihood":
        from .infer.loglik import log_likelihood
        return log_likelihood
    if name == "Laplace":
        from .infer.laplace import Laplace
        return Laplace
    if name == "map_estimate":
        from .infer.laplace import map_estimate
        return map_estimate
    if name == "ParallelTempering":
        from .infer.mcmc import ParallelTempering
        return ParallelTempering
    if name == "SGMCMC":
        from .infer.sgmcmc import SGMCMC
        return SGMCMC
    if name == "SVGD":
        from .infer.svgd import SVGD
        return SVGD
    raise AttributeError(name)
