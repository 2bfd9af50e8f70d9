"""The whole served forward's share of the card's bf16 peak: the forward
FLOPs of a frame (every member's, counted at set-up on the reference net)
times the frames the untraced stretch returned, over its seconds, over 989
TFLOP/s."""

import roofline


def read(ctx):
    frames = ctx.untraced.counts.get("frames", 0)
    flops = ctx.constants.get("flops_per_frame")
    if not frames or not flops or ctx.untraced.seconds <= 0:
        return None
    return 100.0 * flops * frames / ctx.untraced.seconds / \
        roofline.H100_BF16_FLOPS
