"""A stack-serve loop: each request is ``Segmentor.predict`` of one recorded
movie (a held-out stack of frames), returning the probability maps and the
atoms' coordinates on the host.

The served weights are fitted at set-up by the benchmark's plain loop
(``weights.fit_served``) and handed to the program. After the window a
seeded sample of the requests is judged: the maps against the plain
reference's forward of the same stack, and the coordinates against the
plain Locator run on the program's own maps (the threshold makes a
coordinate jump where a map lies at it, so the Locator stage is checked
from the program's maps, and the maps by themselves).
"""

import numpy as np
import torch

import inputs
import roofline
from harness import seeds
from reference import compare, locate
from reference import unet as ref_unet
from weights import fit_served

RATE = "serve_samples_per_s"
LATENCY = "call_p95_ms"


class State:
    pass


def _inputs(run):
    """The run's stacks and the served weights, made from its seed."""
    cfg, mix, st = run.config, run.traffic, State()
    s_train, s_w, st.s_check, *s_pool = seeds(run.seed,
                                              3 + mix["pool_stacks"])
    spec = dict(cfg["data"]["train"], n_images=cfg["serve"]["frames"])
    st.pool = [inputs.frames(spec, s)[0] for s in s_pool]
    train = inputs.frames(cfg["data"]["train"], s_train)
    run.mark("frames")
    st.base, _, run.info["weights_fit"] = fit_served(
        cfg, {"train": train}, run.device, s_w)
    run.mark("served_weights")
    return st


def setup(run):
    import atomai_tpu_torch as aoi
    cfg, mix = run.config, run.traffic
    st = _inputs(run)
    model = cfg["model"]
    st.m = aoi.models.Segmentor(
        model["name"], model["nb_classes"], device=run.device,
        nb_filters=model["nb_filters"], layers=list(model["layers"]))
    st.m.net.load_state_dict(st.base)
    run.mark("program")
    st.kept, st.atoms = inputs.Reservoir(0, st.s_check), []
    for i in range(mix["warmup_calls"]):
        request(run, st, i)
    run.mark("warmup")
    st.kept = inputs.Reservoir(mix["check_calls"], st.s_check)
    st.atoms = []
    return st


def request(run, st, i):
    k = i % len(st.pool)
    with run.span("predict"):
        maps, coords = st.m.predict(st.pool[k], verbose=False)
    n, h, w = st.pool[k].shape
    atoms = sum(len(c) for c in coords.values())
    st.atoms.append(atoms)
    st.kept.offer(lambda: (k, maps, coords))
    return {"samples": n, "frames": n, "labeller_calls": 1,
            "labeller_bytes": roofline.locator_bytes(n, h, w, atoms)}


@torch.no_grad()
def reference_maps(run, net, stack: np.ndarray, block: int = 16
                   ) -> np.ndarray:
    """The reference's (n, h, w, 1) probability maps of a stack, min-max
    normalised over the whole stack, in blocks of frames."""
    x = torch.from_numpy(stack).to(run.device)[:, None]
    lo = x.min()
    x = (x - lo) / torch.clamp(x.max() - lo, min=1e-12)
    net.eval()
    with ref_unet.float32_exact():
        out = torch.cat([torch.sigmoid(net(x[s:s + block]))
                         for s in range(0, len(x), block)])
    return out.permute(0, 2, 3, 1).cpu().numpy()


def check(run, st):
    del st.m
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    if run.trace:        # counted after the window, to keep set-up short
        n, h, w = st.pool[0].shape
        run.constants["flops_per_frame"] = roofline.net_flops(
            ref_unet.build(run.config["model"], "meta"), (1, 1, h, w), False)
    run.info["atoms_per_call"] = [int(min(st.atoms)), int(max(st.atoms))] \
        if st.atoms else None
    net = ref_unet.build(run.config["model"], run.device)
    net.load_state_dict(st.base)
    map_gap = coord_gap = 0.0
    for k, maps, coords in st.kept.items:
        map_gap = max(map_gap, compare.max_abs_gap(
            maps, reference_maps(run, net, st.pool[k])))
        coord_gap = max(coord_gap, compare.coord_gap(
            coords, locate.locate(maps)))
    if not st.kept.items:
        return {}
    return {"map_gap": map_gap, "coord_gap": coord_gap}


def control_readings(run, compute_dtype, coord_dtype) -> dict:
    """The numbers of :func:`check` with the reference put in the program's
    place, its convs in ``compute_dtype`` and its centres in
    ``coord_dtype``, on the run's stacks."""
    st = _inputs(run)
    net = ref_unet.build(run.config["model"], run.device)
    net.load_state_dict(st.base)
    map_gap = coord_gap = 0.0
    for stack in st.pool:
        ref = reference_maps(run, net.set_quant(None), stack)
        ctrl = reference_maps(run, net.set_quant(compute_dtype), stack)
        map_gap = max(map_gap, compare.max_abs_gap(ctrl, ref))
        coord_gap = max(coord_gap, compare.coord_gap(
            locate.locate(ctrl, coord_dtype=coord_dtype),
            locate.locate(ctrl)))
    return {"map_gap": map_gap, "coord_gap": coord_gap}
