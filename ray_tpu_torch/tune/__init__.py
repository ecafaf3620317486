"""ray_tpu_torch.tune: hyperparameter tuning over trial actors (the port of
ray_tpu/tune/).

Parity surface: ray.tune (Tuner, tune.run, search spaces, ASHA, PBT) —
reference python/ray/tune/. Trials are thread actors of the port's
in-process runtime, so ``ray_tpu_torch.init()`` comes first; a trial
reports through ``ray_tpu_torch.train.report``. The reference also records
library usage on import (``record_library_usage("tune")``); usage stats
belong to the util layer, not ported yet (ROADMAP queue 1 item 8), so this
package records nothing.
"""

from ray_tpu_torch.tune.schedulers import (
    PB2,
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
    create_bohb,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    OptunaSearch,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.tuner import ResultGrid, TrialResult, TuneConfig, Tuner, run

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "TrialResult", "run",
    "uniform", "loguniform", "randint", "choice", "grid_search",
    "BasicVariantGenerator", "Searcher", "TPESearcher", "OptunaSearch",
    "ASHAScheduler", "PopulationBasedTraining", "FIFOScheduler", "TrialScheduler",
    "MedianStoppingRule", "PB2", "create_bohb",
]
