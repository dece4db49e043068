"""Device selection, precision policy, NaN guards, FLOP counts and
observability (profiler traces, step timers, JSONL metrics)."""
from ratio_guided_multimodal_fm_tpu_torch.core.dtypes import (
    BF16_POLICY,
    DEFAULT_POLICY,
    Policy,
    cast_floating,
)
from ratio_guided_multimodal_fm_tpu_torch.core.prng import RNG, set_seed

__all__ = ["BF16_POLICY", "DEFAULT_POLICY", "Policy", "RNG",
           "cast_floating", "set_seed"]
