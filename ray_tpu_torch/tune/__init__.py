"""ray_tpu_torch.tune: hyperparameter optimization on trial actors (port
of ray_tpu/tune): ``Tuner.fit`` over a controller that runs each trial in
an actor of the port's runtime, searchers (grid and random, TPE, GP-EI,
Optuna), schedulers (ASHA, median stopping, PBT, PB2, resource changing),
experiment snapshots and ``Tuner.restore``, and a trainer as the
trainable (``Tuner(JaxTrainer(...))``, each trial gang-reserving the
trainer's workers). A trial that asks for ``"GPU"`` runs in an actor
bound to the card.

Trainables travel by reference (``tuner.py``): define them at the top
level of an importable module, or of a driver script with a file.
"""

from ray_tpu_torch.util.usage import record_library_usage as _rlu

_rlu("tune")

from ray_tpu_torch.train.session import report  # shared session API  # noqa: F401
from ray_tpu_torch.train.session import get_checkpoint  # noqa: F401
from ray_tpu_torch.train._checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    DistributeResources,
    FIFOScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    ResourceChangingScheduler,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    BayesOptSearcher,
    ConcurrencyLimiter,
    OptunaSearch,
    Searcher,
    TPESearcher,
)
from ray_tpu_torch.tune.search_space import (
    choice,
    grid_search,
    lograndint,
    loguniform,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.callbacks import (  # noqa: F401
    Callback,
    CSVLoggerCallback,
    JsonLoggerCallback,
    MLflowLoggerCallback,
    TensorBoardLoggerCallback,
    WandbLoggerCallback,
)
from ray_tpu_torch.tune.resources import PlacementGroupFactory, with_resources
from ray_tpu_torch.tune.tuner import TuneConfig, Tuner, run, with_parameters

__all__ = [
    "ASHAScheduler",
    "BasicVariantGenerator",
    "Checkpoint",
    "ConcurrencyLimiter",
    "FIFOScheduler",
    "MedianStoppingRule",
    "OptunaSearch",
    "PB2",
    "PopulationBasedTraining",
    "ResourceChangingScheduler",
    "DistributeResources",
    "ResultGrid",
    "Searcher",
    "TPESearcher",
    "BayesOptSearcher",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "Callback",
    "PlacementGroupFactory",
    "with_resources",
    "CSVLoggerCallback",
    "JsonLoggerCallback",
    "MLflowLoggerCallback",
    "TensorBoardLoggerCallback",
    "WandbLoggerCallback",
    "choice",
    "get_checkpoint",
    "grid_search",
    "lograndint",
    "loguniform",
    "quniform",
    "randint",
    "randn",
    "report",
    "run",
    "sample_from",
    "uniform",
    "with_parameters",
]
