"""A live ensemble-serve loop: each request is one new frame of a running
experiment, analysed as AtomAI's deep-ensemble workflow does: the
ensemble's mean and variance (``EnsemblePredictor.predict``), every
member's map (``ensemble_forward``), and the atoms each member finds,
clustered over the members (``ensemble_locate``).

The served weights (a base net, then members fine-tuned from it with seeds
apart) are fitted at set-up by the benchmark's plain loop
(``weights.fit_served``). After the window a seeded sample of the requests
is judged: the members' maps, the mean and the variance against the plain
reference's forwards of the same frame, and the cluster means against the
plain Locator and DBSCAN run on the program's own maps (the threshold makes
a coordinate jump where a map lies at it, so that stage is checked from
the program's maps, and the maps by themselves).
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
    """The run's frames and the served weights, made from its seed."""
    cfg, mix, st = run.config, run.traffic, State()
    s_base, s_members, s_pool, s_w, st.s_check = seeds(run.seed, 5)
    data = cfg["data"]
    st.pool = inputs.frames(dict(data["members"], n_images=mix[
        "pool_frames"]), s_pool)[0]
    frames = {"base": inputs.frames(data["base"], s_base),
              "members": inputs.frames(data["members"], s_members)}
    run.mark("frames")
    st.base, st.members, run.info["weights_fit"] = fit_served(
        cfg, frames, run.device, s_w)
    run.mark("served_weights")
    return st


def setup(run):
    import atomai_tpu_torch as aoi
    from atomai_tpu_torch.predictors import ensemble_locate
    cfg, mix = run.config, run.traffic
    st = _inputs(run)
    model = cfg["model"]
    skeleton = aoi.models.Segmentor(
        model["name"], model["nb_classes"], device=run.device,
        nb_filters=model["nb_filters"], layers=list(model["layers"])).net
    skeleton.load_state_dict(st.base)
    st.p = aoi.predictors.EnsemblePredictor(
        skeleton, st.members, nb_classes=model["nb_classes"], verbose=0)
    st.locate = ensemble_locate
    run.mark("program")
    st.loc_kwargs = dict(eps=cfg["serve"]["eps"],
                         min_samples=cfg["serve"]["min_samples"],
                         device=str(run.device))
    st.kept, st.clusters = inputs.Reservoir(0, st.s_check), []
    for i in range(mix["warmup_calls"]):
        request(run, st, i)
    run.mark("warmup")
    st.kept = inputs.Reservoir(mix["check_calls"], st.s_check)
    st.clusters = []
    return st


def request(run, st, i):
    k = i % len(st.pool)
    frame = st.pool[k]
    with run.span("predict"):
        mean, var = st.p.predict(frame)
    with run.span("ensemble_forward"):
        maps = st.p.ensemble_forward(st.p.preprocess(frame))
    with run.span("ensemble_locate", sync=True):
        means, _ = st.locate(maps, **st.loc_kwargs)
    n_models = len(st.members)
    found = len(means[0])
    st.clusters.append(found)
    st.kept.offer(lambda: (k, mean, var, maps, means[0]))
    h, w = frame.shape
    return {"samples": 1, "frames": 1, "labeller_calls": 1,
            "labeller_bytes": roofline.locator_bytes(n_models, h, w,
                                                     n_models * found)}


@torch.no_grad()
def reference_maps(run, st, net, frame: np.ndarray) -> np.ndarray:
    """(members, 1, h, w, 1) reference probability maps of one frame,
    min-max normalised over the frame."""
    x = frame.astype(np.float32)
    x = (x - x.min()) / max(np.ptp(x), 1e-12)
    x = torch.from_numpy(x).to(run.device)[None, None]
    outs = []
    net.eval()
    with ref_unet.float32_exact():
        for k in sorted(st.members):
            net.load_state_dict({**st.base, **st.members[k]})
            outs.append(torch.sigmoid(net(x)).permute(0, 2, 3, 1))
    return torch.stack(outs).cpu().numpy()


def check(run, st):
    del st.p
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    if run.trace:        # counted after the window, to keep set-up short
        h, w = st.pool.shape[1:]
        run.constants["flops_per_frame"] = len(st.members) * \
            roofline.net_flops(ref_unet.build(run.config["model"], "meta"),
                               (1, 1, h, w), False)
    run.info["clusters_per_call"] = [int(min(st.clusters)),
                                     int(max(st.clusters))] \
        if st.clusters else None
    if not st.kept.items:
        return {}
    net = ref_unet.build(run.config["model"], run.device)
    serve = run.config["serve"]
    gaps = {"map_gap": 0.0, "moment_gap": 0.0, "cluster_gap": 0.0}
    for k, mean, var, maps, means in st.kept.items:
        ref = reference_maps(run, st, net, st.pool[k])
        gaps["map_gap"] = max(gaps["map_gap"], compare.max_abs_gap(maps, ref))
        gaps["moment_gap"] = max(
            gaps["moment_gap"], compare.max_abs_gap(mean, ref.mean(0)),
            compare.max_abs_gap(var, ref.var(0)))
        member_coords = [locate.locate(m)[0] for m in maps]
        run.info.setdefault("member_atoms_checked", []).append(
            sum(len(c) for c in member_coords))
        gaps["cluster_gap"] = max(gaps["cluster_gap"], compare.matched_gap(
            means, locate.cluster_means(member_coords, serve["eps"],
                                        serve["min_samples"])))
    return gaps


def control_readings(run, compute_dtype, coord_dtype) -> dict:
    """The numbers of :func:`check` with the reference put in the program's
    place, its convs in ``compute_dtype`` and its centres and cluster means
    in ``coord_dtype``, on as many of the run's frames as a check
    compares."""
    st = _inputs(run)
    net = ref_unet.build(run.config["model"], run.device)
    serve = run.config["serve"]
    gaps = {"map_gap": 0.0, "moment_gap": 0.0, "cluster_gap": 0.0}
    for frame in st.pool[:run.traffic["check_calls"]]:
        ref = reference_maps(run, st, net.set_quant(None), frame)
        ctrl = reference_maps(run, st, net.set_quant(compute_dtype), frame)
        gaps["map_gap"] = max(gaps["map_gap"],
                              compare.max_abs_gap(ctrl, ref))
        gaps["moment_gap"] = max(
            gaps["moment_gap"], compare.max_abs_gap(ctrl.mean(0),
                                                    ref.mean(0)),
            compare.max_abs_gap(ctrl.var(0), ref.var(0)))
        coords = [locate.locate(m)[0] for m in ctrl]
        gaps["cluster_gap"] = max(gaps["cluster_gap"], compare.matched_gap(
            locate.cluster_means(coords, serve["eps"], serve["min_samples"],
                                 coord_dtype=coord_dtype),
            locate.cluster_means(coords, serve["eps"],
                                 serve["min_samples"])))
    return gaps
