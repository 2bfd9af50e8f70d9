"""Self-describing checkpoints (counterpart of `atomai_tpu/core/checkpoint.py`).

The contract is the JAX package's: one file holds a JSON meta header (the
model type and its constructor arguments) and the arrays, so a model can
be rebuilt from the file alone. The payload differs: the card's machine
has neither flax nor msgpack, so it is ``torch.save`` of a (nested) dict
of CPU tensors::

    file = 8-byte little-endian header length
         | JSON meta header
         | torch.save payload, read back with ``weights_only=True``

The port's files take the suffix ``.aoit``. :func:`load_checkpoint` also
reads the JAX package's ``.aoi`` files, whose payload is flax's msgpack
(``core/msgpack.py``): their arrays come back as the JAX package's nested
dicts of numpy arrays, under flax's names, for the weight bridge
(``models/conversion.py``) to turn into ``state_dict``s. The format
follows the suffix: ``.aoi`` is msgpack, anything else ``torch.save``. A
path without either suffix is ``<path>.aoit`` if that file exists, else
``<path>.aoi`` if that one does (the JAX package appends ``.aoi``), else
``<path>.aoit``. Writing stays ``.aoit``.

Writes are atomic (temp file + ``os.replace``): a process killed mid-save
leaves the previous checkpoint intact. :func:`save_checkpoint_async`
snapshots the tensors on their device (a copy queued on the current
stream, so later in-place optimizer steps cannot race it) and leaves the
device-to-host copy, the serialisation and the write to one background
thread, so a training loop that saves every epoch never waits on them.
"""

import io
import json
import os
import queue
import struct
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import msgpack

SUFFIX = ".aoit"
JAX_SUFFIX = ".aoi"


def _path(filename: str) -> str:
    return filename if filename.endswith(SUFFIX) else filename + SUFFIX


def resolve_path(filename: str) -> str:
    """The file a checkpoint name stands for: itself with a ``.aoit`` or
    ``.aoi`` suffix, else ``<name>.aoit`` if it exists, else
    ``<name>.aoi`` if it exists, else ``<name>.aoit``."""
    if filename.endswith((SUFFIX, JAX_SUFFIX)):
        return filename
    for suffix in (SUFFIX, JAX_SUFFIX):
        if os.path.exists(filename + suffix):
            return filename + suffix
    return filename + SUFFIX


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_cpu(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return torch.as_tensor(np.asarray(leaf))


def _payload(arrays: Dict[str, Any]) -> bytes:
    buf = io.BytesIO()
    torch.save(_map(_to_cpu, arrays), buf)
    return buf.getvalue()


def _header(meta: Dict[str, Any]) -> bytes:
    return json.dumps(meta, default=_json_default).encode("utf-8")


def save_checkpoint(filename: str, meta: Dict[str, Any],
                    arrays: Dict[str, Any]) -> str:
    """Writes meta (JSON-able dict) and arrays (nested dict of tensors or
    arrays) to one file, atomically; returns the file's path."""
    filename = _path(filename)
    _atomic_write(filename, _header(meta), _payload(arrays))
    return filename


_TMP_COUNTER = [0]
_TMP_COUNTER_LOCK = threading.Lock()


def _atomic_write(filename: str, header: bytes, payload: bytes) -> None:
    # unique per (pid, call): the writer thread and a synchronous save of
    # the same file must never share a temp file
    with _TMP_COUNTER_LOCK:
        _TMP_COUNTER[0] += 1
        n = _TMP_COUNTER[0]
    tmp = f"{filename}.{os.getpid()}.{n}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(header)))
            f.write(header)
            f.write(payload)
        os.replace(tmp, filename)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class _AsyncWriter:
    """One daemon thread draining a save queue. A newer save of a file
    supersedes a queued older one (epoch checkpoints only need the
    latest); errors are kept and raised by :meth:`flush`."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._pending: Dict[str, Tuple[bytes, Any]] = {}
        self._lock = threading.Lock()
        self._thread = None
        self._last_error: Optional[BaseException] = None

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._drain, daemon=True)
            self._thread.start()

    def _drain(self):
        while True:
            fname = self._q.get()
            try:
                with self._lock:
                    item = self._pending.pop(fname, None)
                if item is not None:
                    header, arrays = item
                    _atomic_write(fname, header, _payload(arrays))
            except Exception as e:  # noqa: BLE001 - raised again by flush()
                self._last_error = e
            finally:
                # task_done() runs on a failed write too, or flush() hangs
                self._q.task_done()

    def submit(self, filename: str, header: bytes, arrays: Any) -> None:
        with self._lock:
            superseded = filename in self._pending
            self._pending[filename] = (header, arrays)
            if not superseded:
                self._ensure_thread()
                self._q.put(filename)

    def flush(self) -> None:
        """Blocks until every queued save is on disk; raises the last
        background write error."""
        self._q.join()
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err


_ASYNC_WRITER = _AsyncWriter()


def _snapshot(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    return np.copy(leaf)


def save_checkpoint_async(filename: str, meta: Dict[str, Any],
                          arrays: Dict[str, Any]) -> str:
    """Like :func:`save_checkpoint`, but only the on-device snapshot runs
    on the caller's thread; the copy to the host, the serialisation and
    the write run on the background thread. Call
    :func:`flush_async_checkpoints` before reading the file back."""
    filename = _path(filename)
    _ASYNC_WRITER.submit(filename, _header(meta), _map(_snapshot, arrays))
    return filename


def flush_async_checkpoints() -> None:
    _ASYNC_WRITER.flush()


def load_checkpoint(filename: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(meta, arrays) of a file written by :func:`save_checkpoint` (the
    arrays as CPU tensors, in ``state_dict`` form) or by the JAX package's
    ``save_checkpoint`` (a ``.aoi`` file: the arrays as nested dicts of
    numpy arrays under flax's names); see :func:`resolve_path` for a name
    without a suffix."""
    filename = resolve_path(filename)
    with open(filename, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(hlen).decode("utf-8"))
        payload = f.read()
    if filename.endswith(JAX_SUFFIX):
        return meta, msgpack.restore(payload)
    return meta, torch.load(io.BytesIO(payload), weights_only=True)


def is_jax_tree(arrays: Any) -> bool:
    """Whether a checkpoint's arrays are the JAX package's (flax module
    names, which never hold a dot) rather than the port's ``state_dict``s
    (whose keys always do)."""
    def keys(tree):
        for k, v in tree.items():
            yield k
            if isinstance(v, dict):
                yield from keys(v)
    params = arrays.get("params", arrays) if isinstance(arrays, dict) \
        else {}
    names = list(keys(params)) if isinstance(params, dict) else []
    return bool(names) and not any("." in str(k) for k in names)


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"Not JSON serializable: {type(o)}")
