"""The spatial-MLP backward's share of its roofline: the bound of a step's
backward (``roofline_vae.bound_s``) times the traced steps, over the
summed time of its launches in the trace: ``bwd_wgmma`` (or the staged
``bwd_kernel``), its ``reduce_kernel`` of the blocks' partial gradients
and its half of ``pack_kernel`` (``spatial_mlp_fwd_roofline``)."""

import re

import harness

_fwd = harness.load_module("metrics", "spatial_mlp_fwd_roofline")
BACKWARD = re.compile(
    r"\(anonymous namespace\)::(bwd_wgmma|bwd_kernel|reduce_kernel)\b")


def read(ctx):
    return _fwd.read(ctx, BACKWARD, "bwd_bound_s")
