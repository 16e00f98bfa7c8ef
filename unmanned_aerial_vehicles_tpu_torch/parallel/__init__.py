"""Sweeps and the full-corpus GP over a ``torch.distributed`` mesh (a world
of one without a process group): the row-sharded GP with its CG solve,
flight and hyperparameter sweeps, and the mesh helpers."""

from .distributed_gp import (
    PerDimShardedGP,
    ShardedGPPosterior,
    fit_per_dim_gp_sharded,
    fit_residual_gp_sharded,
    lml_grad_sharded,
    optimize_hyperparameters_sharded,
    predict_mean_sharded,
    predict_per_dim_sharded,
    predict_sharded,
)
from .sharding import (
    Mesh,
    batch_sharding,
    make_mesh,
    replicated_sharding,
    shard_batch,
)
from .sweep import (
    SweepResult,
    hyperparameter_search_step,
    sharded_flight_sweep,
    sharded_structured_flight_sweep,
    structured_flight_sweep,
)

__all__ = [
    "PerDimShardedGP",
    "ShardedGPPosterior",
    "fit_per_dim_gp_sharded",
    "predict_per_dim_sharded",
    "fit_residual_gp_sharded",
    "lml_grad_sharded",
    "optimize_hyperparameters_sharded",
    "predict_mean_sharded",
    "predict_sharded",
    "Mesh",
    "batch_sharding",
    "make_mesh",
    "replicated_sharding",
    "shard_batch",
    "SweepResult",
    "hyperparameter_search_step",
    "sharded_flight_sweep",
    "sharded_structured_flight_sweep",
    "structured_flight_sweep",
]
