"""The whole rVAE training step's share of the card's bf16 peak: the FLOPs
of the reference's step at the cell's shapes (forward and autograd
backward, counted at set-up by FlopCounterMode on meta tensors) times the
steps of the untraced stretch, over its seconds, over 989 TFLOP/s."""

import roofline


def read(ctx):
    steps = ctx.untraced.counts.get("steps", 0)
    flops = ctx.constants.get("flops_per_step")
    if not steps or not flops or ctx.untraced.seconds <= 0:
        return None
    return 100.0 * flops * steps / ctx.untraced.seconds / \
        roofline.H100_BF16_FLOPS
