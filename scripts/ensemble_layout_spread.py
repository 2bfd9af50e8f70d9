"""How far config D's ensemble fits lie from each other, by member layout
and precision, on one CUDA card: three fits of the "map" loop and one of
the "vmap" layout from the same seeds, for 10 and 30 float32 cycles (TF32
off) and for 1 and 10 cycles of the card's bf16 policy, with config D's
augmentation; each pair's distance as ``chip_smoke._ens_diff`` measures it
(the members' mean losses, relative; weights, absolute; running
statistics, of their scale) and the statistic that sets it. Two loop fits
differ only by the atomics of the upsampling's backward; the vmap layout
also rounds every conv and BatchNorm in another order.

    python3 scripts/ensemble_layout_spread.py
"""
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke as cs
from atomai_tpu_torch.core import Precision
from atomai_tpu_torch.trainers import EnsembleTrainer
from atomai_tpu_torch.transforms import seg_augmentor
from atomai_tpu_torch.utils import make_lattice_stack


def worst_statistic(a, b):
    """(distance of scale, member, name) of the running statistic that
    sets ``_ens_diff``'s ``stats_rel``."""
    return max((float((a[2][i][k].float() - v.float()).abs().max() /
                      v.abs().max()), i, k)
               for i, sb in b[2].items() for k, v in sb.items()
               if ".running_" in k)


def main():
    d = torch.device("cuda", 0)
    torch.cuda.set_device(d)
    cs.phase_device(d)
    imgs, masks, _ = make_lattice_stack(**cs.ENS_DATA)
    aug = seg_augmentor(1, **cs.AUG)
    with tempfile.TemporaryDirectory() as tmp:
        for f32, cycles in ((True, 10), (True, 30), (False, 1), (False, 10)):
            runs = {}
            for name, layout in (("map0", "map"), ("map1", "map"),
                                 ("map2", "map"), ("vmap0", "vmap")):
                et = EnsembleTrainer("Unet", 1, device=d)
                if f32:
                    et.precision = Precision.full()
                et.compile_ensemble_trainer(
                    training_cycles=cycles, batch_size=cs.ENS_BATCH,
                    swa=True, member_layout=layout,
                    filename=os.path.join(tmp, name))
                with cs.quiet():
                    runs[name] = (et,) + et.train_ensemble_from_scratch(
                        imgs, masks, n_models=cs.ENS_MODELS,
                        augment_fn=aug)
            names = list(runs)
            for i, a in enumerate(names):
                for b in names[i + 1:]:
                    print(json.dumps({
                        "policy": "float32" if f32 else "bf16",
                        "cycles": cycles, "pair": [a, b],
                        **cs._ens_diff(runs[a], runs[b]),
                        "worst_statistic": worst_statistic(runs[a],
                                                           runs[b])}),
                          flush=True)


if __name__ == "__main__":
    main()
