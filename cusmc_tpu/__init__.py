"""cusmc_tpu — an accelerator-native SMC/MCMC inference framework in JAX.

Brand-new JAX/XLA implementation of the capability surface of the CuSMC
reference package (bootstrap particle filtering with Metropolis
resampling over multivariate Normal / Student-T state-space models, plus
direct distribution sampling and Metropolis-Hastings MCMC): the whole
filter is one compiled ``lax.scan`` on the GPU, and particles and chains
shard over a ``jax.sharding.Mesh``.

Public API (capability parity with the reference R surface, NAMESPACE:3-8):
``run``, ``MVN``, ``MVNPDF``, ``MVT``, ``MVTPDF``, ``metropolis_hastings``.
"""

__version__ = "0.1.0"

from cusmc_tpu.api import (  # noqa: F401
    MVN,
    MVNPDF,
    MVT,
    MVTPDF,
    metropolis_hastings,
    run,
)
from cusmc_tpu.config import FilterConfig, run_filter  # noqa: F401
from cusmc_tpu.models.clgssm import CLGSSM  # noqa: F401
from cusmc_tpu.models.dlm import DLM  # noqa: F401
from cusmc_tpu.smc.enkf import EnKFResult, ensemble_kalman_filter  # noqa: F401
from cusmc_tpu.smc.kalman import kalman_filter  # noqa: F401
from cusmc_tpu.smc.liu_west import LiuWestResult, liu_west_filter  # noqa: F401
from cusmc_tpu.smc.rbpf import RBPFResult, rao_blackwell_filter  # noqa: F401
from cusmc_tpu.smc.smc2 import SMC2Result, smc2  # noqa: F401
from cusmc_tpu.smc.particle_filter import (  # noqa: F401
    FilterResult,
    bootstrap_filter,
)
from cusmc_tpu.smc.smc_sampler import smc_sampler  # noqa: F401
from cusmc_tpu.smc.streaming import streaming_bootstrap_filter  # noqa: F401
from cusmc_tpu.mcmc.metropolis import metropolis_hastings_sampler  # noqa: F401
