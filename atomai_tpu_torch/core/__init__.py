"""Precision policy, seeding, device meshes, checkpoints, the metrics log,
the SWA state, export and profiling."""

from . import mesh, profiling
from .checkpoint import (flush_async_checkpoints, load_checkpoint,
                         save_checkpoint, save_checkpoint_async)
from .device import resolve_device
from .dtypes import (Precision, default_precision, enable_fast_matmul,
                     head_f32, set_default_precision)
from .export import ExportedModel, export_model, load_exported
from .mesh import data_sharding, ensemble_mesh, get_mesh, replicate
from .mlog import MetricsLogger, open_metrics_log
from .prng import GeneratorSeq, generator_from_seed
from .profiling import annotate, device_memory_stats, trace
from .state import SwaState

__all__ = ["Precision", "default_precision", "head_f32",
           "set_default_precision", "GeneratorSeq", "generator_from_seed",
           "save_checkpoint", "save_checkpoint_async",
           "flush_async_checkpoints", "load_checkpoint", "MetricsLogger",
           "open_metrics_log", "SwaState", "resolve_device", "enable_fast_matmul",
           "export_model", "load_exported", "ExportedModel", "profiling",
           "trace", "annotate", "device_memory_stats", "get_mesh",
           "data_sharding", "replicate", "ensemble_mesh"]
