"""The ensemble trainer's two member layouts' gradients against float64, on
one step of config D's members (4 Unets at full width, a batch of 8 frames
of 512² each, the trainer's loss) on one CUDA card.

"map" is the single-model step, member by member (cuDNN's convolutions
and BatchNorm); "vmap" is one ``torch.func.vmap`` of ``functional_call``
over the stacked members (grouped convolutions, the elementwise
``VmapBatchNorm``). Each is computed in float32 (TF32 off) and under the
card's bf16 policy, and compared, parameter by parameter, with the same
step in float64: the largest |difference| over the float64 gradient's
largest |value|. One JSON line a layout and precision, with the worst
parameters, the median over parameters, and the share of parameters
where that layout's float32 error is the larger of the two.

    python3 scripts/ensemble_layout_gradients.py [--device cuda]
"""
import argparse
import copy
import json
import os
import sys

import numpy as np
import torch
from torch.func import functional_call, vmap

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke as cs
from atomai_tpu_torch.core import Precision
from atomai_tpu_torch.core.prng import generator_from_seed
from atomai_tpu_torch.losses_metrics import select_loss
from atomai_tpu_torch.nets import fcnn, init_fcnn_model, init_weights_
from atomai_tpu_torch.nets.functional_bn import autocast_in_vmap, vmappable
from atomai_tpu_torch.utils import make_lattice_stack


def member_grads(nets, Xs, Ys, layout, precision, device):
    """{parameter: (members, ...) gradients} of one step of each member."""
    crit = select_loss("ce", 1)

    def forward(net, x):
        with precision.scope(device):
            return net(x.permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1)
    if layout == "map":
        grads = []
        for net, x, y in zip(nets, Xs, Ys):
            net = copy.deepcopy(net)
            with precision.tf32_scope():
                crit(forward(net, x), y).backward()
            grads.append({k: p.grad for k, p in net.named_parameters()})
        return {k: torch.stack([g[k] for g in grads]) for k in grads[0]}
    skeleton = vmappable(copy.deepcopy(nets[0]))
    params = {k: torch.stack([n.get_parameter(k).detach() for n in nets])
              .requires_grad_() for k, _ in skeleton.named_parameters()}
    buffers = {k: torch.stack([n.get_buffer(k).clone() for n in nets])
               for k, _ in skeleton.named_buffers()}
    with precision.tf32_scope(), autocast_in_vmap():
        out = vmap(lambda p, b, x: forward(
            lambda xx: functional_call(skeleton, (p, b), (xx,)), x))(
                params, buffers, torch.stack(Xs))
        sum(crit(out[j], Ys[j]) for j in range(len(nets))).backward()
    return {k: p.grad for k, p in params.items()}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--frames", type=int, default=cs.ENS_BATCH)
    parser.add_argument("--size", type=int, default=cs.ENS_DATA["size"])
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        cs.phase_device(device)
    data = dict(cs.ENS_DATA, size=args.size)
    imgs, masks, _ = make_lattice_stack(**data)
    X = torch.from_numpy(imgs[..., None]).float().to(device)
    Y = torch.from_numpy(masks).float().to(device)
    n, b = cs.ENS_MODELS, args.frames
    Xs = [X[i * b:(i + 1) * b] for i in range(n)]
    Ys = [Y[i * b:(i + 1) * b] for i in range(n)]
    nets = []
    for i in range(n):
        net = init_fcnn_model("Unet", 1)[0]
        init_weights_(net, generator_from_seed(10 + i))
        nets.append(net.to(device).train())
    # float64: the map layout with the head in float64 too
    head = fcnn.head_f32
    fcnn.head_f32 = lambda layer, x: layer(x)
    try:
        ref = member_grads([copy.deepcopy(m).double() for m in nets],
                           [x.double() for x in Xs],
                           [y.double() for y in Ys], "map",
                           Precision.full(), device)
    finally:
        fcnn.head_f32 = head
    errs = {}
    for policy, precision in (("float32", Precision.full()),
                              ("bf16", Precision.mixed())):
        for layout in ("map", "vmap"):
            g = member_grads(nets, Xs, Ys, layout, precision, device)
            e = {k: float((g[k].double() - r).abs().max() /
                          r.abs().max()) for k, r in ref.items()}
            errs[policy, layout] = e
            worst = sorted(e.items(), key=lambda kv: -kv[1])[:4]
            print(json.dumps({"policy": policy, "layout": layout,
                              "worst": worst,
                              "median": float(np.median(list(e.values())))
                              }), flush=True)
        m, v = errs[policy, "map"], errs[policy, "vmap"]
        print(json.dumps({"policy": policy, "map_error_larger_share":
                          float(np.mean([m[k] > v[k] for k in m]))}),
              flush=True)


if __name__ == "__main__":
    main()
