"""Ahead-of-time model export for serving (counterpart of
`atomai_tpu/core/export.py:42-211`), through ``torch.export``.

:func:`export_model` traces a trained model's eval-mode forward, with its
weights, into an ``ExportedProgram``, so that serving needs neither the
model class nor this package's trainers: only torch. The forward is the
trainer's own (the JAX package's layouts: channel-last images in, the
net's raw output out, float32), under the model's precision policy: a
model on the card exports its bfloat16 autocast regions, one on the CPU
runs float32. With ``batch_polymorphic`` the batch axis is a symbolic
``torch.export.Dim``, so one artifact serves any batch size.

File layout, as the JAX package's (and ``core.checkpoint``'s)::

    8-byte little-endian header length | JSON header | torch.export.save

The header's ``magic`` is this package's own, and the suffix ``.aott``;
:func:`load_exported` refuses the JAX package's ``.aot`` artifacts
(StableHLO, which only JAX runs) with a ``ValueError``. An artifact keeps
the device it was traced on in its weights; :class:`ExportedModel` moves
them to the device it is asked to serve on, so a file written on the CPU
serves on the card.
"""

import io
import json
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .device import resolve_device
from .dtypes import Precision

MAGIC = "atomai_tpu_torch_exported"
JAX_MAGIC = "atomai_tpu_exported"
SUFFIX = ".aott"
FORMAT_VERSION = 1
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _EvalForward(nn.Module):
    """A model's eval-mode forward as a module: the trainer's ``forward``
    (its layouts and precision policy) over its net."""

    def __init__(self, model):
        super().__init__()
        self.net = model.net
        self._forward = model.forward

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward(x)


def _infer_example_shape(model) -> Tuple[int, ...]:
    """Per-sample input shape as the model's trainer stages it (JAX
    `export.py:108-126`): the staged training data's, or else the
    metadict's ``in_dim`` (an ImSpec model's as it is, an image model's
    with a channel axis)."""
    meta = getattr(model, "meta_state_dict", {}) or {}
    staged = getattr(model, "Xb_train", None)
    if staged is not None:
        return tuple(int(s) for s in staged.shape[2:])
    in_dim = meta.get("in_dim")
    if in_dim:
        in_dim = tuple(int(s) for s in in_dim)
        if meta.get("model_type") == "imspec":
            return in_dim
        return in_dim + (1,) if len(in_dim) in (1, 2) else in_dim
    raise ValueError(
        "Could not infer the input shape — pass example_shape=(H, W, C)")


def export_model(model, filename: str,
                 example_shape: Optional[Tuple[int, ...]] = None,
                 batch_polymorphic: bool = True) -> str:
    """Exports a trained model's eval-mode forward (weights included) as a
    serving artifact; returns the written path (``.aott`` appended when
    the name has no suffix).

    ``model``: a Segmentor, ImSpec, Regressor, Classifier or
    DenoisingAutoencoder (anything with ``net`` and the trainer's
    ``forward``), traced on its own device under its precision policy.
    ``example_shape``: the per-sample input shape without the batch axis,
    e.g. ``(256, 256, 1)``; inferred from the staged training data or the
    metadict's ``in_dim`` when omitted. ``batch_polymorphic``: a symbolic
    batch axis (any batch size); False pins batch 1."""
    net = getattr(model, "net", None)
    if net is None or not hasattr(model, "forward"):
        raise ValueError("Model must be initialized/trained before export")
    if example_shape is None:
        example_shape = _infer_example_shape(model)
    example_shape = tuple(int(s) for s in example_shape)
    device = next(net.parameters()).device
    was_training = net.training
    net.eval()
    try:
        batch = 2 if batch_polymorphic else 1
        x = torch.zeros((batch,) + example_shape, device=device)
        dynamic = ({"x": {0: torch.export.Dim("batch")}}
                   if batch_polymorphic else None)
        with torch.no_grad():
            program = torch.export.export(_EvalForward(model), (x,),
                                          dynamic_shapes=dynamic)
    finally:
        net.train(was_training)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    precision = getattr(model, "precision", Precision.full())
    meta = dict(getattr(model, "meta_state_dict", {}) or {})
    header = {
        "magic": MAGIC, "format_version": FORMAT_VERSION,
        "model_type": meta.get("model_type", type(model).__name__),
        "example_shape": list(example_shape),
        "batch_polymorphic": bool(batch_polymorphic),
        "traced_on": device.type, "torch_version": torch.__version__,
        "precision": {"compute_dtype": str(precision.compute_dtype
                                           ).replace("torch.", ""),
                      "allow_tf32": precision.allow_tf32},
        "meta": {k: v for k, v in meta.items()
                 if isinstance(v, (str, int, float, bool, list, tuple,
                                   type(None)))},
    }
    if not filename.endswith(SUFFIX):
        filename = filename + SUFFIX
    blob = json.dumps(header).encode("utf-8")
    with open(filename, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        f.write(buf.getvalue())
    return filename


def _on_device(program, device: torch.device) -> nn.Module:
    """The program's module with its weights, constants and the devices
    the trace baked into its graph (e.g. ``.float()``'s metadata checks)
    moved to ``device``."""
    from torch.export.passes import move_to_device_pass
    return move_to_device_pass(program, device).module()


class ExportedModel:
    """A loaded serving artifact: the traced forward on ``device`` and its
    header. ``predict`` adds the library's input conventions
    (channel-last float32, min-max normalisation over the stack,
    chunking) around the raw ``__call__``, as JAX `export.py:130-188`."""

    def __init__(self, header: Dict[str, Any], exported, device) -> None:
        self.header = header
        self.meta = header.get("meta", {})
        self.model_type = header.get("model_type")
        self.example_shape = tuple(header.get("example_shape", ()))
        self.device = resolve_device(device)
        p = header.get("precision", {})
        self.precision = Precision(
            _DTYPES[p.get("compute_dtype", "float32")],
            bool(p.get("allow_tf32", False)))
        self.module = _on_device(exported, self.device)

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        """The raw forward of a batch (numpy or tensor) on the device."""
        x = torch.as_tensor(np.asarray(x, np.float32)
                            if not isinstance(x, torch.Tensor) else x)
        x = x.to(self.device, torch.float32)
        with self.precision.tf32_scope():
            if not self.header.get("batch_polymorphic", True) and \
                    x.shape[0] != 1:
                return torch.cat([self.module(x[i:i + 1])
                                  for i in range(x.shape[0])])
            return self.module(x)

    def _canonicalize(self, x: np.ndarray) -> np.ndarray:
        """(N,) + example_shape: adds a missing batch axis, and adds or
        drops a singleton channel axis to match the traced shape."""
        es = self.example_shape
        if x.shape[1:] == es:
            return x
        if x.shape == es:
            return x[None]
        if x.ndim >= 1 and x.shape[1:] + (1,) == es:
            return x[..., None]
        if x.shape + (1,) == es:
            return x[None, ..., None]
        if x.shape[-1] == 1 and x.shape[1:-1] == es:
            return x[..., 0]
        if x.shape[-1] == 1 and x.shape[:-1] == es:
            return x[..., 0][None]
        raise ValueError(
            f"Input shape {x.shape} does not match the exported "
            f"program's per-sample shape {es}")

    def predict(self, imgs, norm: bool = True, max_batch: int = 32
                ) -> np.ndarray:
        """Batched eval-mode forward with the library's input conventions
        (float32, channel-last, min-max normalisation over the stack), as
        numpy; the stack goes to the device once, is normalised there and
        comes back in one copy."""
        x = torch.from_numpy(np.ascontiguousarray(self._canonicalize(
            np.asarray(imgs, np.float32)))).to(self.device)
        if norm:
            lo, hi = x.min(), x.max()
            spread = hi > lo          # a constant stack stays as it is
            x = (x - torch.where(spread, lo, 0.0)) / torch.where(
                spread, hi - lo, 1.0)
        outs = [self(x[i:i + max_batch]).float()
                for i in range(0, x.shape[0], max_batch)]
        return torch.cat(outs).cpu().numpy()


def load_exported(filename: str, device: str = "cuda") -> ExportedModel:
    """Loads an artifact written by :func:`export_model`, to serve on
    ``device`` (the card by default; "cpu" when asked for). The JAX
    package's ``.aot`` artifacts and other files raise ``ValueError``."""
    try:
        with open(filename, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen).decode("utf-8"))
            payload = f.read()
        if not isinstance(header, dict):
            raise ValueError
    except (struct.error, UnicodeDecodeError, json.JSONDecodeError,
            OverflowError, ValueError):
        raise ValueError(f"{filename} is not an atomai_tpu_torch export")
    if header.get("magic") == JAX_MAGIC:
        raise ValueError(
            f"{filename} is an export of the JAX package (a StableHLO "
            "program, which only JAX runs); export the model with "
            "atomai_tpu_torch.export_model, e.g. after loading its .aoi "
            "checkpoint with atomai_tpu_torch.load_model")
    if header.get("magic") != MAGIC:
        raise ValueError(f"{filename} is not an atomai_tpu_torch export")
    program = torch.export.load(io.BytesIO(payload))
    return ExportedModel(header, program, device)
