"""mendeliht — a sparse-regression (iterative hard thresholding) framework
for genome-wide association studies, in JAX.

Written in JAX / XLA / Pallas / jax.sharding; feature parity target is
OpenMendel/MendelIHT.jl (see SURVEY.md).  The public API mirrors the
reference's surface:

  - ``fit_iht(y, x, z, k=..., d=..., l=...)``       (reference: src/fit.jl:60)
  - ``cv_iht(y, x, z, path=..., q=...)``            (reference: src/cross_validation.jl:60)
  - ``iht_run_many_models(...)``                    (reference: src/cross_validation.jl:232)
  - ``iht(filename, k, d, ...)``                    (reference: src/wrapper.jl:52)
  - ``cross_validate(filename, d, ...)``            (reference: src/wrapper.jl:301)
  - simulation helpers                              (reference: src/simulate_utilities.jl)

Design notes:
  * Genotypes live in a 2-bit packed, SNP-major, crumb-transposed layout
    (`genotype.PackedGenotypes`) decoded on the fly — by a fused Pallas
    kernel on a GPU, by XLA elsewhere — with standardization and
    mean-imputation fused algebraically.
  * The IHT solver is a single jitted `lax.while_loop` over a functional state
    pytree; cross-validation folds and sparsity levels form a *batch axis* that
    is pushed through the solver so each `X'R` becomes one large multi-RHS
    matmul (the reference instead uses a CPU thread pool).
  * Sample masking (0/1 ``cv_wts``) — the reference's own trick — replaces any
    data movement between folds.
"""

import os as _os

# Persistent compile cache inside the checkout (listed in .gitignore), used
# only when JAX_COMPILATION_CACHE_DIR does not name one.
CACHE_DIR = _os.path.join(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))), ".jax_cache")


def _enable_compile_cache():
    """Persistent XLA compilation cache, on by default.

    If JAX_COMPILATION_CACHE_DIR is set, JAX uses it and this sets no other
    directory; otherwise the cache is :data:`CACHE_DIR`.  The solver
    while_loop takes tens of seconds to compile cold; the cache makes every
    later process pay seconds instead.  Reference analog: the __init__-time
    precompilation in reference src/MendelIHT.jl:54-59."""
    import jax
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compile_cache()

from .ops.glm import (
    Normal, Bernoulli, Poisson, NegativeBinomial, Gamma, InverseGaussian,
    MvNormal, Binomial,
    IdentityLink, LogitLink, LogLink, InverseLink, SqrtLink, ProbitLink,
    CloglogLink, InverseSquareLink, canonicallink,
)
from .genotype import (
    PackedGenotypes, SnpData, read_plink, write_plink_bed, merge_plink,
    maf, grm,
)
from .ops.streaming import HostStreamedGenotypes
from .genotype.snparray import naive_impute
from .compat import (
    loglikelihood, deviance, score, mle_for_r, initialize_beta,
    cv_iht_distribute_fold,
)
from .models.fit import fit_iht
from .models.cv import cv_iht, iht_run_many_models, allocate_fold_and_k
from .models.results import IHTResult, MIHTResult
from .utils.wrapper import iht, cross_validate, parse_genotypes, parse_phenotypes, parse_covariates
from .utils.simulate import (
    simulate_random_snparray, simulate_correlated_snparray,
    simulate_random_response, simulate_random_multivariate_response,
    random_covariance_matrix, make_bim_fam_files, adhoc_add_correlation,
    make_snparray,
)
from .utils.weights import maf_weights
from .models.pve import pve_from_model as pve
from .ops.projections import project_k, project_group_sparse
from .utils.standardize import standardize

__version__ = "0.1.0"

__all__ = [
    "fit_iht", "cv_iht", "iht_run_many_models", "allocate_fold_and_k",
    "iht", "cross_validate",
    "IHTResult", "MIHTResult",
    "PackedGenotypes", "SnpData", "read_plink", "write_plink_bed",
    "merge_plink", "HostStreamedGenotypes", "maf", "grm",
    "Normal", "Bernoulli", "Poisson", "NegativeBinomial", "Gamma",
    "InverseGaussian", "MvNormal", "Binomial",
    "IdentityLink", "LogitLink", "LogLink", "InverseLink", "SqrtLink",
    "ProbitLink", "CloglogLink", "InverseSquareLink", "canonicallink",
    "simulate_random_snparray", "simulate_correlated_snparray",
    "simulate_random_response", "simulate_random_multivariate_response",
    "random_covariance_matrix", "make_bim_fam_files", "adhoc_add_correlation",
    "make_snparray",
    "maf_weights", "pve", "project_k", "project_group_sparse", "standardize",
    "parse_genotypes", "parse_phenotypes", "parse_covariates",
    "naive_impute", "loglikelihood", "deviance", "score", "mle_for_r",
    "initialize_beta", "cv_iht_distribute_fold",
]
