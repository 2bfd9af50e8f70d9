"""Weights the benchmark makes and hands to the program and the reference
alike: a seeded initial draw, and served weights fitted by a plain loop.

Nothing here imports the program. The initial draw is torch's default for
convolutions (weights and biases from U(+-1/sqrt(fan_in))) and identity
BatchNorms, made on the device from one generator in one call. The served
weights come from :func:`fit_served`: the reference net trained with Adam
under bf16 autocast (this only makes inputs), on random batches of the
configuration's frames, as the configuration's ``served_weights`` states:
AtomAI's binary cross-entropy with logits over every pixel, and torch's
Adam written out.
"""

import math
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from reference import unet as ref_unet


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Mean binary cross-entropy of (n, 1, h, w) logits and (n, h, w)
    labels, in the numerically stable form."""
    z = logits[:, 0].float()
    return (z.clamp(min=0) - z * labels + torch.log1p(torch.exp(-z.abs()))
            ).mean()


class Adam:
    """torch's Adam (no weight decay, no amsgrad) over named parameters."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_steps(net: torch.nn.Module,
                batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                lr: float = 1e-3, autocast: bool = False) -> List[float]:
    """One Adam step of ``net`` on each (NHWC images, (n, h, w) masks)
    batch, under bf16 autocast with ``autocast``: each step's loss."""
    params = dict(net.named_parameters())
    opt = Adam(params, lr)
    losses = []
    net.train()
    for X, y in batches:
        for p in params.values():
            p.grad = None
        with torch.autocast(X.device.type, dtype=torch.bfloat16,
                            enabled=autocast):
            out = net(X.permute(0, 3, 1, 2))
        loss = bce_with_logits(out, y)
        loss.backward()
        opt.step({k: p.grad.detach() for k, p in params.items()})
        losses.append(loss.detach())
    return [float(v) for v in torch.stack(losses).cpu()]


def initial_state(model: dict, device, seed: int) -> Dict[str, torch.Tensor]:
    """A seeded initial ``state_dict`` of the configuration's net."""
    net = ref_unet.build(model, "meta")
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    total = sum(m.weight.numel() + m.bias.numel() for m in convs)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    draw = torch.rand(total, generator=g, device=device).mul_(2).sub_(1)
    by_module, at = {}, 0
    for m in convs:
        bound = 1.0 / math.sqrt(m.in_channels * math.prod(m.kernel_size))
        for p in (m.weight, m.bias):
            by_module[id(p)] = draw[at:at + p.numel()].view(p.shape) * bound
            at += p.numel()
    state = {}
    for name, t in net.state_dict(keep_vars=True).items():
        if id(t) in by_module:
            state[name] = by_module[id(t)].contiguous()
        elif name.endswith("running_var") or name.endswith(".weight"):
            state[name] = torch.ones(t.shape, device=device)
        elif name.endswith("num_batches_tracked"):
            state[name] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            state[name] = torch.zeros(t.shape, device=device)
    return state


def _fit(model: dict, state: Dict[str, torch.Tensor], X: torch.Tensor,
         y: torch.Tensor, steps: int, batch: int, lr: float, seed: int
         ) -> Tuple[Dict[str, torch.Tensor], float]:
    """``state`` trained for ``steps`` Adam steps on random batches of (X,
    y): (the new state, the last loss)."""
    net = ref_unet.build(model, X.device)
    net.load_state_dict(state)
    g = torch.Generator(device=X.device)
    g.manual_seed(int(seed))
    idx = torch.randint(0, len(X), (steps, batch), generator=g,
                        device=X.device)
    losses = train_steps(net, ((X[i], y[i]) for i in idx), lr,
                            autocast=X.device.type == "cuda")
    net.eval()
    return {k: v.detach().clone() for k, v in net.state_dict().items()}, \
        losses[-1]


def fit_served(cfg: dict, frames: Dict[str, Tuple[np.ndarray, np.ndarray]],
               device, seed: int) -> Tuple[Dict, Dict[int, Dict], dict]:
    """The served weights of a configuration: (the base ``state_dict``,
    {member: ``state_dict``} (empty without members), a record of the
    fit). ``frames`` maps a data entry's name to its (images, masks)."""
    spec = cfg["served_weights"]
    ss = np.random.SeedSequence(seed)
    s_init, s_base, *s_members = ss.generate_state(2 + spec.get(
        "members", {}).get("count", 0))

    def tensors(name):
        imgs, masks = frames[name]
        return (torch.from_numpy(imgs[..., None]).float().to(device),
                torch.from_numpy(masks).float().to(device))

    base = spec["base"]
    X, y = tensors(base["data"])
    state, last = _fit(cfg["model"], initial_state(cfg["model"], device,
                                                   s_init),
                       X, y, base["steps"], base["batch"], base["lr"], s_base)
    record = {"base_last_loss": last}
    members = {}
    if "members" in spec:
        mem = spec["members"]
        X, y = tensors(mem["data"])
        for i, s in enumerate(s_members):
            members[i], last = _fit(cfg["model"], state, X, y, mem["steps"],
                                    mem["batch"], mem["lr"], s)
            record[f"member{i}_last_loss"] = last
    return state, members, record
