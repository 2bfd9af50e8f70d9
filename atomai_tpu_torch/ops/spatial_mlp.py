"""The rVAE's fused spatial-decoder MLP: CUDA kernels and plain versions.

Counterpart of `atomai_tpu/ops/pallas_mlp.py` (the TPU kernel pair
`_fwd_kernel`/`_bwd_kernel` behind a custom VJP). For M = B * n pixel
rows::

    h0 = tanh(x @ Wc + bc + zb[sample])
    hl = tanh(h(l-1) @ Ws[l] + bs[l])        l = 1..L
    y  = hL @ Wo + bo

- :func:`spatial_mlp` keeps the JAX signature and its (B, 2, n) in /
  (B, 1, n) out layout. A CPU tensor goes to :func:`spatial_mlp_reference`
  (autograd differentiates it); a CUDA tensor goes to the forward kernel of
  ``csrc/spatial_mlp.cu`` inside a ``torch.autograd.Function`` whose
  backward is the backward kernel. Neither keeps activations: the backward
  recomputes them on chip, as the TPU kernel does.
- :func:`spatial_mlp_reference` and :func:`spatial_mlp_backward_reference`
  are the plain versions (the forward of `pallas_mlp.py:239-247`, the
  explicit gradient formulas of `_bwd_kernel`) in float32 torch.

The kernels take bf16 operands with f32 accumulation (the TPU kernel's
precision), H a multiple of 16 in [16, 512] (:func:`mlp_shapes_supported`),
any L >= 0 and any n: the tail tile is masked, so rows need no padding.
Their design is in the source's header: ``wgmma`` products with the
activation chain in registers for H up to 256 (forward) and 128
(backward: one block an SM, a producer streaming the weights to two
consumer warpgroups), a staged ``wmma`` path beyond. Each call packs the
weights to bf16 into a workspace that the wrapper keeps per device and
pass, sized once per shape (:func:`_workspace`); the kernels allocate
nothing.
:func:`spatial_mlp_flops` and :func:`spatial_mlp_bytes` count the work for
the bounds of ``roofline``.
"""

import ctypes
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core import profiling
from . import _build

_SOURCE = "spatial_mlp.cu"
_lib = None
_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_SOURCE)
        lib.spatial_mlp_forward.argtypes = [_P] * 10 + [ctypes.c_longlong] \
            + [_I] * 4 + [_P]
        lib.spatial_mlp_forward.restype = _I
        lib.spatial_mlp_workspace.argtypes = [_I] * 4 + [
            ctypes.POINTER(ctypes.c_longlong)] * 2
        lib.spatial_mlp_workspace.restype = _I
        lib.spatial_mlp_backward.argtypes = [_P] * 13 + [ctypes.c_longlong] + \
            [_I] * 4 + [_P, ctypes.POINTER(_I)]
        lib.spatial_mlp_backward.restype = _I
        lib.spatial_mlp_error_string.argtypes = [_I]
        lib.spatial_mlp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Builds and loads the kernel library now (otherwise at first use)."""
    _library()


def mlp_shapes_supported(hidden: int) -> bool:
    """Whether the kernels take this hidden width (any depth, any rows)."""
    return 16 <= hidden <= 512 and hidden % 16 == 0


def spatial_mlp_flops(B: int, n: int, H: int, L: int) -> Tuple[int, int]:
    """Matrix-product FLOPs (2·M·K·N each, M = B·n rows) of the forward
    and of the backward; elementwise work (biases, tanh, column sums) is
    not counted. Forward: h0 (K = 2), L hidden layers, the head. Backward:
    the recomputed h0..hL, the head's dWo and dh, each hidden layer's dW
    and dh, and dWc and dx."""
    M = B * n
    forward = 2 * M * (2 * H + L * H * H + H)
    backward = 2 * M * (2 * H + L * H * H) + 2 * M * (2 * H) \
        + 2 * M * (2 * L * H * H) + 2 * M * (4 * H)
    return forward, backward


def spatial_mlp_bytes(B: int, n: int, H: int, L: int) -> Tuple[int, int]:
    """Device-memory bytes the forward and the backward must move, each
    float32 input read once and each output written once: x, zb and the
    weights in, y out; the backward reads gy too and writes dx, dzb and a
    gradient of every weight."""
    weights = 4 * (3 * H + L * H * H + L * H + H + 1)
    rows = 4 * B * n
    forward = 2 * rows + 4 * B * H + weights + rows
    backward = 2 * rows + 4 * B * H + weights + rows \
        + 2 * rows + 4 * B * H + weights
    return forward, backward


def _dims(xT, zb, Wc, bc, Ws, bs, Wo, bo) -> Tuple[int, int, int, int]:
    if xT.ndim != 3 or xT.shape[1] != 2:
        raise ValueError(f"xT must be (B, 2, n), got {tuple(xT.shape)}")
    B, _, n = xT.shape
    H = Wc.shape[-1]
    L = Ws.shape[0]
    expected = {"zb": (B, H), "Wc": (2, H), "bc": (1, H), "Ws": (L, H, H),
                "bs": (L, H), "Wo": (H, 1), "bo": (1, 1)}
    for name, t in zip(expected, (zb, Wc, bc, Ws, bs, Wo, bo)):
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} must be {expected[name]}, got "
                             f"{tuple(t.shape)}")
    return B, n, H, L


def _check_cuda(tensors, B, H) -> None:
    device = tensors[0].device
    for t in tensors:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"the kernels take CUDA tensors on one device, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
    if not mlp_shapes_supported(H):
        raise ValueError(f"hidden width {H} outside the kernels' range "
                         "(a multiple of 16 in [16, 512])")
    if B > 65535:
        raise ValueError(f"batch {B} above the kernels' 65535")


# workspace bytes (forward, backward) per (B, n, H, L, device), and one
# workspace tensor per (device, pass), grown when a shape needs more: both
# are made once, not on every call
_WS_BYTES = {}
_WORKSPACES = {}


def _workspace(dev: torch.device, which: int, dims) -> Tuple[torch.Tensor,
                                                             int]:
    key = dims + (dev.index,)
    if key not in _WS_BYTES:
        fwd, bwd = ctypes.c_longlong(0), ctypes.c_longlong(0)
        _raise_on(_library().spatial_mlp_workspace(
            *dims, ctypes.byref(fwd), ctypes.byref(bwd)), "workspace query")
        _WS_BYTES[key] = (fwd.value, bwd.value)
    nbytes = _WS_BYTES[key][which]
    ws = _WORKSPACES.get((dev.index, which))
    if ws is None or ws.numel() < nbytes:
        ws = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)
        _WORKSPACES[(dev.index, which)] = ws
    return ws, nbytes


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"spatial_mlp {what} failed: "
                           + _library().spatial_mlp_error_string(err).decode())


def spatial_mlp_forward_cuda(xT, zb, Wc, bc, Ws, bs, Wo, bo) -> torch.Tensor:
    """Launches the forward kernel on contiguous float32 CUDA tensors;
    returns y (B, 1, n). Counts ``spatial_mlp.forward_launches``."""
    args = (xT, zb, Wc, bc, Ws, bs, Wo, bo)
    B, n, H, L = _dims(*args)
    _check_cuda(args, B, H)
    lib = _library()
    y = torch.empty((B, 1, n), dtype=torch.float32, device=xT.device)
    with torch.cuda.device(xT.device):
        ws, nbytes = _workspace(xT.device, 0, (B, n, H, L))
        stream = torch.cuda.current_stream(xT.device).cuda_stream
        err = lib.spatial_mlp_forward(*(a.data_ptr() for a in args),
                                      y.data_ptr(), ws.data_ptr(), nbytes,
                                      B, n, H, L, stream)
    _raise_on(err, "forward launch")
    profiling.count("spatial_mlp.forward_launches")
    return y


def spatial_mlp_backward_cuda(xT, zb, Wc, bc, Ws, bs, Wo, bo, gy):
    """Launches the backward kernel (and its reduction); returns the
    gradients of the eight inputs (dx, dzb, dWc, dbc, dWs, dbs, dWo, dbo),
    float32, with the inputs' shapes. Counts
    ``spatial_mlp.backward_launches``, and
    ``spatial_mlp.backward_pipelined_launches`` when the launch took the
    pipelined ``bwd_wgmma`` (HP 64 or 128) rather than the staged kernel."""
    args = (xT, zb, Wc, bc, Ws, bs, Wo, bo)
    B, n, H, L = _dims(*args)
    if tuple(gy.shape) != (B, 1, n):
        raise ValueError(f"gy must be {(B, 1, n)}, got {tuple(gy.shape)}")
    _check_cuda(args + (gy,), B, H)
    lib = _library()
    dev = xT.device
    dx = torch.empty((B, 2, n), dtype=torch.float32, device=dev)
    dzb = torch.empty((B, H), dtype=torch.float32, device=dev)
    sizes = [L * H * H, L * H, H, 1, 2 * H, H]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    pipelined = _I(0)
    with torch.cuda.device(dev):
        ws, nbytes = _workspace(dev, 1, (B, n, H, L))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spatial_mlp_backward(
            *(a.data_ptr() for a in args), gy.data_ptr(), dx.data_ptr(),
            dzb.data_ptr(), flat.data_ptr(), ws.data_ptr(), nbytes,
            B, n, H, L, stream, ctypes.byref(pipelined))
    _raise_on(err, "backward launch")
    profiling.count("spatial_mlp.backward_launches")
    if pipelined.value:
        profiling.count("spatial_mlp.backward_pipelined_launches")
    dWs, dbs, dWo, dbo, dWc, dbc = torch.split(flat, sizes)
    return (dx, dzb, dWc.view(2, H), dbc.view(1, H), dWs.view(L, H, H),
            dbs.view(L, H), dWo.view(H, 1), dbo.view(1, 1))


class _SpatialMLP(torch.autograd.Function):
    """Forward kernel; its backward is the backward kernel. Saves only the
    inputs: the activations are recomputed on chip."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.float32)
    def forward(ctx, *args):
        args = tuple(a.contiguous() for a in args)
        ctx.save_for_backward(*args)
        return spatial_mlp_forward_cuda(*args)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, gy):
        return spatial_mlp_backward_cuda(*ctx.saved_tensors,
                                         gy.float().contiguous())


def spatial_mlp(xT, zb, Wc, bc, Ws, bs, Wo, bo, remat: bool = False
                ) -> torch.Tensor:
    """Fused tanh-MLP over pixel rows.

    Args:
        xT: (B, 2, n) transposed coordinates (any n).
        zb: (B, H) per-sample latent embedding (z @ Wz).
        Wc: (2, H), bc: (1, H) coordinate embedding.
        Ws: (L, H, H) in (in, out) layout, bs: (L, H) hidden layers.
        Wo: (H, 1), bo: (1, 1) output head.
        remat: recompute the activations in the backward instead of
            keeping them. The CUDA kernels always do (their backward
            recomputes on chip, once a step, with no second forward
            launch); the plain version is then run under
            ``torch.utils.checkpoint``.
    Returns:
        (B, 1, n) float32: the plain version for CPU tensors, the CUDA
        kernels (differentiable) for CUDA tensors.
    """
    if xT.device.type == "cpu":
        args = (xT, zb, Wc, bc, Ws, bs, Wo, bo)
        if remat:
            return checkpoint(spatial_mlp_reference, *args,
                              use_reentrant=False)
        return spatial_mlp_reference(*args)
    if xT.device.type == "cuda":
        return _SpatialMLP.apply(xT, zb, Wc, bc, Ws, bs, Wo, bo)
    raise ValueError(f"spatial_mlp runs on 'cpu' or 'cuda' tensors, got "
                     f"device {xT.device}")


def _hidden(xT, zb, Wc, bc, Ws, bs):
    x = xT.transpose(1, 2)                                   # (B, n, 2)
    hs = [torch.tanh(x @ Wc + bc + zb[:, None, :])]
    for l in range(Ws.shape[0]):
        hs.append(torch.tanh(hs[-1] @ Ws[l] + bs[l]))
    return x, hs


def spatial_mlp_reference(xT, zb, Wc, bc, Ws, bs, Wo, bo) -> torch.Tensor:
    """Plain torch forward, in the inputs' dtype (float32 in the tests)."""
    _, hs = _hidden(xT, zb, Wc, bc, Ws, bs)
    y = hs[-1] @ Wo + bo[0]
    return y.transpose(1, 2)                                 # (B, 1, n)


def spatial_mlp_backward_reference(xT, zb, Wc, bc, Ws, bs, Wo, bo, gy):
    """Plain torch gradients of sum(spatial_mlp(...) * gy) with respect to
    the eight inputs, by the explicit formulas of the TPU backward kernel
    (`pallas_mlp.py:94-144`): recompute h0..hL, then back-propagate
    ``G = dh * (1 - h^2)`` layer by layer."""
    x, hs = _hidden(xT, zb, Wc, bc, Ws, bs)
    g = gy.transpose(1, 2)                                   # (B, n, 1)
    L = Ws.shape[0]
    dWo = torch.einsum("bnh,bno->ho", hs[L], g)
    dbo = g.sum().reshape(1, 1)
    dh = g @ Wo.T                                            # (B, n, H)
    dWs = torch.zeros_like(Ws)
    dbs = torch.zeros_like(bs)
    for l in range(L - 1, -1, -1):
        G = dh * (1.0 - hs[l + 1] * hs[l + 1])
        dWs[l] = torch.einsum("bni,bno->io", hs[l], G)
        dbs[l] = G.sum((0, 1))
        dh = G @ Ws[l].T
    G0 = dh * (1.0 - hs[0] * hs[0])
    dWc = torch.einsum("bnk,bnh->kh", x, G0)
    dbc = G0.sum((0, 1))[None]
    dx = (G0 @ Wc.T).transpose(1, 2)                         # (B, 2, n)
    dzb = G0.sum(1)
    return dx, dzb, dWc, dbc, dWs, dbs, dWo, dbo
