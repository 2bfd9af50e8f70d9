"""SegResNet's training step in both packages from one state, in float32 on
the CPU: the port's (``atomai_tpu_torch``) and the JAX package's
(``atomai_tpu``), from the same weights, BatchNorm statistics and Adam
moments (carried to flax by the weight bridge,
``atomai_tpu_torch.models.conversion.reference_to_jax``) on the same
batches.

``compare_step`` takes one step in each and gives the loss of each, and
for every parameter the largest difference of the gradients and of the
Adam updates over the JAX leaf's largest magnitude.
``tests/test_torch_segresnet_spike.py`` runs it at a small width in the
regime ``scripts/segresnet_spike_trace.py`` found on the card.

As a script it replays the card's state before a spike: it reads the
``snapshot.pt`` that ``segresnet_spike_trace.py`` wrote (the net's and
Adam's states ``LEAD`` cycles before the spike, and the batch schedule),
stages phase 20's data as the fit staged it, compares the first step, then
trains both packages from that state for ``--cycles`` cycles on the
scheduled batches and prints the two losses of each cycle (a spike in
both, or in one only). It takes the first ``--frames`` (8) frames of each
scheduled batch of 32 (the whole batch is config A at full size, for the
card, where the JAX package does not run); a step of 8 frames of 256²
takes seconds in each package on a few cores.

    JAX_PLATFORMS=cpu python3 scripts/segresnet_spike_step.py \
        chiprun_out/segresnet_spike_trace_f32/snapshot.pt [--cycles 25]
"""
import argparse
import contextlib
import io
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LR = 1e-3


def port_net(nb_filters, state):
    from atomai_tpu_torch.nets import SegResNet
    net = SegResNet(1, nb_filters)
    net.load_state_dict(state)
    return net.train()


def port_adam(net, adam):
    """torch Adam(1e-3) over ``net`` with the states ``adam`` ({index in
    ``net.parameters()``: {step, exp_avg, exp_avg_sq}})."""
    opt = torch.optim.Adam(net.parameters(), lr=LR, eps=1e-8)
    opt.load_state_dict({"state": {i: dict(st) for i, st in adam.items()},
                         "param_groups": opt.state_dict()["param_groups"]})
    return opt


def port_step(net, opt, X, y):
    """One step of the port (the trainer's forward and loss): (loss, the
    gradients by name, the updates by name)."""
    from atomai_tpu_torch.losses_metrics import select_loss
    crit = select_loss("ce", 1)
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    opt.zero_grad(set_to_none=True)
    out = net(torch.from_numpy(X).permute(0, 3, 1, 2)).float()
    loss = crit(out.permute(0, 2, 3, 1), torch.from_numpy(y))
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in net.named_parameters()}
    opt.step()
    upd = {k: p.detach() - before[k] for k, p in net.named_parameters()}
    return float(loss.detach()), grads, upd


def to_flax(named, buffers):
    """A dict of tensors keyed by the port's parameter names, as the JAX
    package's params tree (the BatchNorm buffers tell BatchNorm layers
    from convs)."""
    from atomai_tpu_torch.models import conversion
    sd = {k: v.detach().numpy() for k, v in {**named, **buffers}.items()}
    return conversion.reference_to_jax(
        sd, conversion._fcnn_mapping("SegResNet", False))


class JaxSide:
    """The JAX package's SegResNet with its params, batch_stats and optax
    Adam(1e-3) state, stepped as its trainer steps."""

    def __init__(self, nb_filters, net, opt):
        import jax
        import jax.numpy as jnp
        import optax
        from atomai_tpu.losses_metrics import select_loss
        from atomai_tpu.nets.fcnn import SegResNet as JaxSegResNet
        self.jax, self.jnp, self.optax = jax, jnp, optax
        names = [k for k, _ in net.named_parameters()]
        buffers = {k: b for k, b in net.named_buffers()
                   if "running" in k}
        self.buffers = buffers
        self.params, self.stats = to_flax(dict(net.named_parameters()),
                                          buffers)
        st = [opt.state[p] for p in net.parameters()]
        mu = to_flax({n: s["exp_avg"] for n, s in zip(names, st)},
                     buffers)[0]
        nu = to_flax({n: s["exp_avg_sq"] for n, s in zip(names, st)},
                     buffers)[0]
        self.tx = optax.adam(LR)
        state = self.tx.init(self.params)
        self.state = (state[0]._replace(
            count=jnp.asarray(int(st[0]["step"]), jnp.int32), mu=mu,
            nu=nu),) + tuple(state[1:])
        jnet = JaxSegResNet(nb_classes=1, nb_filters=nb_filters)
        crit = select_loss("ce", 1)

        def step(params, stats, state, X, y):
            def loss_fn(p):
                out, mut = jnet.apply({"params": p, "batch_stats": stats},
                                      X, True, mutable=["batch_stats"])
                return crit(out, y), mut["batch_stats"]
            (loss, stats), g = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            upd, state = self.tx.update(g, state, params)
            return loss, g, upd, optax.apply_updates(params, upd), stats, \
                state
        self._step = jax.jit(step)

    def step(self, X, y):
        """(loss, gradients, updates) as numpy trees; the state moves."""
        with self.jax.default_matmul_precision("highest"):
            loss, g, upd, self.params, self.stats, self.state = \
                self._step(self.params, self.stats, self.state, X, y)
        host = self.jax.device_get((loss, g, upd))
        return float(host[0]), host[1], host[2]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


def scaled_diffs(got, want):
    """{leaf path: max |got - want| / max |want|} of two flax trees."""
    w = dict(_leaves(want))
    return {k: float(np.abs(v - w[k]).max() / max(np.abs(w[k]).max(),
                                                  1e-30))
            for k, v in _leaves(got)}


def pre_bn_bias(leaf):
    """Whether a flax leaf is the bias of a conv that feeds a BatchNorm
    directly (a ResBlock's 3x3 convs): its true gradient is 0, so both
    packages' gradients are rounding noise of either sign."""
    return "ResBlock" in leaf and leaf.endswith(("Conv_1/bias",
                                                 "Conv_2/bias"))


def compare_step(nb_filters, state, adam, X, y):
    """One step of each package from ``state`` (the port's state_dict) and
    ``adam`` (torch Adam states by parameter index) on the batch (X, y)
    (NHWC float32, (N, H, W) float32 masks): {"loss_port", "loss_jax",
    "grad": {leaf: scaled diff}, "update": {leaf: scaled diff},
    "pre_bn_update_abs": the largest |update difference| of the pre-BN
    biases, "update_diff_abs": the largest of every leaf,
    "update_abs": the largest |update| of the JAX step}."""
    net = port_net(nb_filters, state)
    opt = port_adam(net, adam)
    jax_side = JaxSide(nb_filters, net, opt)
    buffers = jax_side.buffers
    loss_j, g_j, u_j = jax_side.step(X, y)
    loss_p, g_p, u_p = port_step(net, opt, X, y)
    u_p = to_flax(u_p, buffers)[0]
    diffs = scaled_diffs(u_p, u_j)
    u_p, u_j = dict(_leaves(u_p)), dict(_leaves(u_j))
    return {"loss_port": loss_p, "loss_jax": loss_j,
            "grad": scaled_diffs(to_flax(g_p, buffers)[0], g_j),
            "update": diffs,
            "pre_bn_update_abs": max(float(np.abs(u_p[k] - u_j[k]).max())
                                     for k in u_j if pre_bn_bias(k)),
            "update_diff_abs": max(float(np.abs(u_p[k] - u_j[k]).max())
                                   for k in u_j),
            "update_abs": max(float(np.abs(v).max())
                              for v in u_j.values())}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("snapshot")
    parser.add_argument("--cycles", type=int, default=1)
    parser.add_argument("--frames", type=int, default=8,
                        help="the first frames of each scheduled batch of "
                             "32 (the whole batch is a full-size run)")
    args = parser.parse_args()
    torch.set_num_threads(min(8, os.cpu_count()))
    import chip_smoke as cs
    from atomai_tpu_torch import models
    from atomai_tpu_torch.utils import make_lattice_stack
    snap = torch.load(args.snapshot, weights_only=False)
    imgs, masks, _ = make_lattice_stack(**cs.MAIN)
    m = models.Segmentor("SegResNet", 1, seed=1, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        m.compile_trainer((imgs, masks), training_cycles=cs.SEG_CYCLES,
                          batch_size=cs.SEG_BATCH)
    Xb = m.Xb_train.numpy()[:, :args.frames]
    yb = m.yb_train.numpy().astype(np.float32)[:, :args.frames]
    sched = np.asarray(snap["schedule"])
    assert (sched == m.batch_idx_train).all()
    c0 = snap["cycle"] + 1
    nf = snap["net"]["c1.block.0.weight"].shape[0]
    first = compare_step(nf, snap["net"], snap["adam"], Xb[sched[c0]],
                         yb[sched[c0]])
    print(json.dumps({
        "cycle": c0, "spike_on_card": snap["spike"],
        "loss_port": first["loss_port"], "loss_jax": first["loss_jax"],
        "loss_rel": abs(first["loss_port"] / first["loss_jax"] - 1),
        "frames": args.frames,
        "grad_worst": sorted([kv for kv in first["grad"].items()
                              if not pre_bn_bias(kv[0])],
                             key=lambda kv: -kv[1])[:3],
        "update_worst": sorted([kv for kv in first["update"].items()
                                if not pre_bn_bias(kv[0])],
                               key=lambda kv: -kv[1])[:3],
        "pre_bn_bias_update_abs_over_lr": first["pre_bn_update_abs"] / LR,
        "largest_update_over_lr": first["update_abs"] / LR}), flush=True)
    net = port_net(nf, snap["net"])
    opt = port_adam(net, snap["adam"])
    jax_side = JaxSide(nf, net, opt)
    for c in range(c0, min(c0 + args.cycles, len(sched))):
        X, y = Xb[sched[c]], yb[sched[c]]
        lj = jax_side.step(X, y)[0]
        lp = port_step(net, opt, X, y)[0]
        print(json.dumps({"cycle": c, "loss_port": lp, "loss_jax": lj}),
              flush=True)


if __name__ == "__main__":
    main()
