"""Precision policy, seeding, checkpoints and the metrics log."""

from .checkpoint import (flush_async_checkpoints, load_checkpoint,
                         save_checkpoint, save_checkpoint_async)
from .dtypes import (Precision, default_precision, head_f32,
                     set_default_precision)
from .mlog import MetricsLogger, open_metrics_log
from .prng import GeneratorSeq, generator_from_seed

__all__ = ["Precision", "default_precision", "head_f32",
           "set_default_precision", "GeneratorSeq", "generator_from_seed",
           "save_checkpoint", "save_checkpoint_async",
           "flush_async_checkpoints", "load_checkpoint", "MetricsLogger",
           "open_metrics_log"]
