"""The port's ``aseutils``, ``datasets`` and ``compat`` on the CPU, against
the JAX package's on the same numpy inputs:
- the POSCAR files of ``ase_obj_basic`` / ``ase_obj_adv``, byte for byte;
- ``stem_smbfo`` / ``stem_graphene`` with ``download=False`` on a ``.npy``
  file the test writes, with every ``urllib`` entry point patched to
  raise (nothing can fetch), and ``download=True`` on a patched
  ``urlretrieve`` that writes the file: the same URL, path and data;
- every staging function of ``compat``, exactly (values and shapes; the
  port's several-class masks are int64 where the JAX package's are
  int32), the data loaders batch for batch with and without a seeded
  shuffle;
- ``Hook`` against flax's ``capture_intermediates`` on the same Unet
  weights, at 1e-5 of each activation's scale (the port's blocks are NCHW,
  the JAX ones NHWC: the JAX activation is transposed; the JAX package
  names its blocks ``ConvBlock_i`` / ``UpsampleBlock_i``, the port ``c1``
  ... ``c6``, ``bn``, ``upsample_block1..3``);
- ``load_weights``, ``nb_filters_classes`` and ``set_seed_and_precision``
  on the committed JAX ``.aoi`` fixture and the port's own files;
  ``dummy_optimizer`` leaves the weights as they are.
"""

import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atomai_tpu import nets as jnets
from atomai_tpu import utils as jutils
from atomai_tpu.core import dtypes as jdtypes
from atomai_tpu.utils import compat as jcompat
from atomai_tpu.utils import datasets as jdatasets
from atomai_tpu_torch import models, nets, utils
from atomai_tpu_torch.core import dtypes as tdtypes
from atomai_tpu_torch.models.conversion import unet_from_jax
from atomai_tpu_torch.utils import compat, datasets

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
UNET_AOI = os.path.join(FIXTURES, "torch_port_unet.aoi")


def _coords(seed, n_classes=2, n=12):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * 64
    return np.concatenate([xy, rng.randint(0, n_classes, (n, 1))], 1)


def _equal(a, b):
    """Exact equality of two (nested) results, numpy or torch leaves."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- aseutils
@pytest.mark.parametrize("case", ["dict", "array", "three_classes"])
@pytest.mark.parametrize("writer", ["basic", "adv"])
def test_poscar_files_equal_jax_byte_for_byte(tmp_path, capsys, case,
                                              writer):
    n_classes = 3 if case == "three_classes" else 2
    map_dict = {0: "C", 1: "Si", 2: "O"} if n_classes == 3 \
        else {0: "Mo", 1: "S"}
    coords = {0: _coords(0, n_classes), 4: _coords(4, n_classes)}
    arg = coords[4] if case == "array" else coords
    files = []
    for name, mod in (("jax", jutils), ("port", utils)):
        path = str(tmp_path / f"{name}.POSCAR")
        if writer == "basic":
            mod.ase_obj_basic(arg, 4, "MoS2", map_dict, path, 0.104)
        else:
            mod.ase_obj_adv([3.19, 0.0, 0.0], [-1.595, 2.7626, 0.0],
                            [0.0, 0.0, 13.1], arg, 4, "MoS2", map_dict,
                            path, 0.104)
        files.append(open(path, "rb").read())
    assert files[0] == files[1] and len(files[0]) > 200
    out = capsys.readouterr().out
    assert out.count("successfully created an ASE object") == 2


# ----------------------------------------------------------------- datasets
def _no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a test reached for the network")
    for name in ("urlopen", "urlretrieve", "build_opener"):
        monkeypatch.setattr(urllib.request, name, refuse)


@pytest.mark.parametrize("which", [
    ("stem_smbfo", "SmBFO_composition_series.npy"),
    ("stem_graphene", "graphene_imgstacks_dict.npy")])
def test_datasets_load_a_local_file_without_network(tmp_path, monkeypatch,
                                                    which):
    fn, fname = which
    _no_network(monkeypatch)
    rng = np.random.RandomState(3)
    data = {"a": {"main_image": rng.rand(8, 8).astype(np.float32),
                  "composition": 0.1}, 1: {"frames": rng.rand(2, 4, 4)}}
    np.save(tmp_path / fname, data, allow_pickle=True)
    got_j = getattr(jdatasets, fn)(download=False, filedir=str(tmp_path))
    got_t = getattr(datasets, fn)(download=False, filedir=str(tmp_path))
    assert got_t.keys() == got_j.keys() == data.keys()
    np.testing.assert_array_equal(got_t["a"]["main_image"],
                                  got_j["a"]["main_image"])
    np.testing.assert_array_equal(got_t[1]["frames"], data[1]["frames"])


@pytest.mark.parametrize("fn", ["stem_smbfo", "stem_graphene"])
def test_datasets_download_path_and_url_match_jax(tmp_path, monkeypatch,
                                                  capsys, fn):
    """``download=True`` through a patched ``urlretrieve`` (which writes
    the file instead of fetching it): the URL, the target path and the
    progress lines the hook prints are the JAX package's."""
    _no_network(monkeypatch)
    calls = []

    def fake_retrieve(url, path, hook):
        calls.append((url, os.path.relpath(path, str(tmp_path))))
        np.save(path, {"k": np.arange(3)}, allow_pickle=True)
        for block in range(3):
            hook(block, 512, 1024)
    monkeypatch.setattr(urllib.request, "urlretrieve", fake_retrieve)
    outs = []
    for mod, sub in ((jdatasets, "jax"), (datasets, "port")):
        os.makedirs(tmp_path / sub)
        got = getattr(mod, fn)(download=True, filedir=str(tmp_path / sub))
        np.testing.assert_array_equal(got["k"], np.arange(3))
        outs.append(capsys.readouterr().out)
    assert calls[0][0] == calls[1][0] and calls[0][0].startswith(
        "https://zenodo.org/")
    assert calls[0][1].split(os.sep)[1] == calls[1][1].split(os.sep)[1]
    assert outs[0] == outs[1] and "100.0%" in outs[0]


# ------------------------------------------------------------------ compat
def _images(seed=0, n=10, classes=1):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 16, 16) * 3 + 1
    y = rng.randint(0, classes + (classes == 1), (n, 16, 16))
    return X, y


@pytest.mark.parametrize("norm", [True, False])
def test_torch_format_functions_match_jax(norm):
    X, _ = _images()
    _equal(compat.torch_format_image(X, norm),
           jcompat.torch_format_image(X, norm))
    spectra = np.random.RandomState(1).rand(6, 1, 32)
    _equal(compat.torch_format_spectra(spectra, norm),
           jcompat.torch_format_spectra(spectra, norm))
    with pytest.warns(UserWarning, match="deprecated"):
        out = compat.torch_format(X)
    with pytest.warns(UserWarning, match="deprecated"):
        _equal(out, jcompat.torch_format(X))
    assert out.shape == (10, 16, 16, 1) and out.dtype == np.float32


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("test_size", [0.15, 0.5])
def test_train_test_split_matches_jax(shuffle, test_size):
    X, y = _images(n=13)
    _equal(compat.train_test_split(X, y, test_size, shuffle, 4),
           jcompat.train_test_split(X, y, test_size, shuffle, 4))


@pytest.mark.parametrize("batch_size", [1, 3, 10])
def test_array2list_matches_jax(batch_size):
    X, y = _images(n=10)
    _equal(compat.array2list_(X, batch_size),
           jcompat.array2list_(X, batch_size))
    _equal(compat.array2list(X, y, X[:5], y[:5], min(batch_size, 5)),
           jcompat.array2list(X, y, X[:5], y[:5], min(batch_size, 5)))
    for mod in (compat, jcompat):
        with pytest.raises(ValueError, match="exceeds"):
            mod.array2list_(X, 11)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64,
                                   np.int32, np.uint8])
@pytest.mark.parametrize("precision", ["single", "double"])
def test_get_array_memsize_matches_jax(dtype, precision):
    a = np.zeros((7, 5), dtype)
    assert compat.get_array_memsize(a, precision) == \
        jcompat.get_array_memsize(a, precision)
    assert compat.get_array_memsize(None) == 0


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("batch_size", [4, 7, 32])
def test_init_dataloader_batches_match_jax(shuffle, batch_size):
    X, y = _images(n=17, classes=3)
    np.random.seed(11)
    want = jcompat.init_dataloader(X, y, batch_size=batch_size,
                                   shuffle=shuffle)
    np.random.seed(11)
    loader = compat.init_dataloader(X, y, batch_size=batch_size,
                                    shuffle=shuffle)
    assert isinstance(loader, torch.utils.data.DataLoader)
    for _ in range(2):      # the drawn order holds on every pass
        got = [tuple(t.numpy() for t in b) for b in loader]
        _equal(got, want)
        assert got[0][0].dtype == X.dtype and got[0][1].dtype == y.dtype


@pytest.mark.parametrize("name", ["init_dataloaders", "init_fcnn_dataloaders",
                                  "init_imspec_dataloaders",
                                  "init_reg_dataloaders",
                                  "init_cls_dataloaders",
                                  "init_vae_dataloaders"])
def test_init_dataloaders_match_jax(name):
    X, y = _images(n=12)
    got = getattr(compat, name)(X, y, X[:5], y[:5], batch_size=4)
    want = getattr(jcompat, name)(X, y, X[:5], y[:5], batch_size=4)
    for loader, batches in zip(got, want):
        _equal([tuple(loader_batch) for loader_batch in loader], batches)


def _reg_cls(seed, n=9, cls=False):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 8, 8)
    y = rng.randint(0, 4, n) if cls else rng.rand(n)
    return X, y


@pytest.mark.parametrize("classes", [1, 3])
def test_preprocess_image_data_matches_jax(classes):
    X, y = _images(n=12, classes=classes)
    got = compat.preprocess_training_image_data(X, y, X[:4], y[:4], 4)
    want = jcompat.preprocess_training_image_data(X, y, X[:4], y[:4], 4)
    _equal(got[:4], want[:4])
    assert got[4] == want[4] == classes
    got = compat.preprocess_training_image_data_(X, y, X[:4], y[:4])
    want = jcompat.preprocess_training_image_data_(X, y, X[:4], y[:4])
    _equal(got[:4], want[:4])
    assert got[4] == want[4]
    # several classes: int64 labels (torch's), int32 in the JAX package
    assert got[1].dtype == (np.int64 if classes > 1 else np.float32)
    assert want[1].dtype == (np.int32 if classes > 1 else np.float32)


def test_preprocess_imspec_data_matches_jax():
    rng = np.random.RandomState(5)
    X, y = rng.rand(10, 1, 8, 8), rng.rand(10, 16)
    _equal(compat.preprocess_training_imspec_data(X, y, X[:4], y[:4], 2),
           jcompat.preprocess_training_imspec_data(X, y, X[:4], y[:4], 2))
    got = compat.preprocess_training_imspec_data_(X, y, X[:4], y[:4])
    want = jcompat.preprocess_training_imspec_data_(X, y, X[:4], y[:4])
    _equal(got[:4], want[:4])
    assert got[4] == want[4] == ((8, 8), (16,))


@pytest.mark.parametrize("task", ["reg", "cls"])
def test_preprocess_reg_cls_data_match_jax(task):
    X, y = _reg_cls(6, cls=task == "cls")
    batched = f"preprocess_training_{task}_data"
    _equal(getattr(compat, batched)(X, y, X[:3], y[:3], 3),
           getattr(jcompat, batched)(X, y, X[:3], y[:3], 3))
    with pytest.warns(UserWarning, match="channel dimension"):
        got = getattr(compat, batched + "_")(X, y, X[:3], y[:3])
    with pytest.warns(UserWarning, match="channel dimension"):
        want = getattr(jcompat, batched + "_")(X, y, X[:3], y[:3])
    _equal(got, want)
    assert [a.dtype for a in got] == [a.dtype for a in want]


def test_denoiser_data_and_aliases_are_the_ports_own():
    """The names compat re-exports are the port's functions, not copies."""
    from atomai_tpu_torch.utils import coords, graphx, img, imgen, nn, viz
    assert compat.extract_patches_ is img.extract_patches_
    assert compat.filter_cells_ is img.filter_cells_
    assert compat.get_intensities_ is coords.get_intensities_
    assert compat.filter_subgraphs_ is graphx.filter_subgraphs_
    assert compat.renumerate_classes_ is nn.renumerate_classes_
    assert compat.create_multiclass_lattice_mask_ is \
        imgen.create_multiclass_lattice_mask_
    for name in ("animation_from_png", "plot_lattice_bonds",
                 "plot_trajectories", "plot_trajectories_transitions",
                 "plot_transitions", "visualize_unmixing_results"):
        assert getattr(compat, name) is getattr(viz, name)
    X = np.random.RandomState(2).rand(6, 16, 16)
    _equal(compat.create_batches(X, 4), jcompat.create_batches(X, 4))


def test_hook_matches_capture_intermediates():
    """Each block's output of the same Unet, captured by the port's forward
    hooks and by flax's ``capture_intermediates``, within 1e-5 of its
    scale."""
    kw = dict(nb_classes=1, nb_filters=4, layers=(1, 1, 1, 1))
    jnet = jnets.Unet(**kw)
    x = np.random.RandomState(7).rand(2, 16, 16, 1).astype(np.float32)
    variables = jnet.init({"params": jax.random.key(3),
                           "dropout": jax.random.key(3)},
                          jnp.asarray(x), False)
    tnet = nets.Unet(**kw)
    tnet.load_state_dict(unet_from_jax(variables["params"],
                                       variables["batch_stats"]))
    jh = jcompat.Hook(jnet, variables)
    out_j = np.asarray(jh(jnp.asarray(x)))
    th = compat.Hook(tnet)
    out_t = th(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out_t.detach().permute(0, 2, 3, 1).numpy(),
                               out_j, atol=1e-5 * np.abs(out_j).max())
    names = {"ConvBlock_0": "c1", "ConvBlock_1": "c2", "ConvBlock_2": "c3",
             "ConvBlock_3": "bn", "ConvBlock_4": "c4", "ConvBlock_5": "c5",
             "ConvBlock_6": "c6", "UpsampleBlock_0": "upsample_block1",
             "UpsampleBlock_1": "upsample_block2",
             "UpsampleBlock_2": "upsample_block3", "Conv_0": "px"}
    for jname, tname in names.items():
        want = np.asarray(jh.intermediates[jname]["__call__"][0])
        got = th.intermediates[tname].detach().permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=tname)
    assert "" in th.intermediates and "c1.block.0" in th.intermediates
    assert tnet.training          # put back as it was before the call
    th.close()
    tnet(torch.zeros(1, 1, 16, 16))
    assert th.intermediates == {} and not tnet._forward_hooks and \
        not tnet.c1._forward_hooks


def test_load_weights_and_nb_filters_classes(tmp_path):
    """The JAX package's ``.aoi`` into a port model, and the port's
    ``.aoit`` into a bare ``nn.Module``: the weights of ``load_model``."""
    ref = models.load_model(UNET_AOI, device="cpu")
    meta = ref.meta_state_dict
    m = models.Segmentor("Unet", meta["nb_classes"], device="cpu",
                         nb_filters=meta["nb_filters"],
                         layers=meta["layers"], seed=9)
    assert compat.load_weights(m, UNET_AOI) is m
    for k, v in ref.net.state_dict().items():
        assert torch.equal(m.net.state_dict()[k], v), k
    path = ref.save_model(str(tmp_path / "unet"))
    bare = nets.Unet(meta["nb_classes"], meta["nb_filters"],
                     layers=tuple(meta["layers"]))
    assert compat.load_weights(bare, path) is bare
    for k, v in ref.net.state_dict().items():
        assert torch.equal(bare.state_dict()[k], v), k
    with pytest.raises(ValueError, match="JAX checkpoint"):
        compat.load_weights(bare, UNET_AOI)
    assert compat.nb_filters_classes(UNET_AOI) == \
        jcompat.nb_filters_classes(UNET_AOI) == \
        compat.nb_filters_classes(path)


@pytest.mark.parametrize("precision", ["single", "double"])
def test_set_seed_and_precision(precision):
    """numpy's global state as the JAX package seeds it, torch's seeded,
    the policy pinned to full float32; "double" leaves torch's default
    dtype (and the nets) float32, as the JAX package's nets stay float32
    under ``jax_enable_x64``."""
    saved = (jdtypes._DEFAULT, tdtypes._OVERRIDE,
             jax.config.jax_enable_x64)
    try:
        jcompat.set_seed_and_precision(5, precision)
        want = np.random.rand(4)
        jx = jnets.Unet(nb_filters=2, layers=(1, 1, 1, 1))
        jdtype = jax.eval_shape(
            lambda k: jx.init({"params": k}, jnp.zeros((1, 8, 8, 1),
                                                       jnp.float32)),
            jax.random.key(0))["params"]["Conv_0"]["kernel"].dtype
        compat.set_seed_and_precision(5, precision)
        np.testing.assert_array_equal(np.random.rand(4), want)
        t0 = torch.rand(3)
        torch.manual_seed(5)
        assert torch.equal(t0, torch.rand(3))
        assert tdtypes.default_precision("cuda") == tdtypes.Precision.full()
        assert torch.get_default_dtype() == torch.float32
        assert jdtype == jnp.float32
        assert next(nets.Unet(nb_filters=2).parameters()).dtype == \
            torch.float32
        with pytest.raises(ValueError, match="precision"):
            compat.set_seed_and_precision(1, "half")
    finally:
        jdtypes._DEFAULT, tdtypes._OVERRIDE = saved[:2]
        jax.config.update("jax_enable_x64", saved[2])


def test_dummy_optimizer_leaves_weights_unchanged(tmp_path):
    X, y = _images(n=8)
    m = models.Segmentor("Unet", 1, nb_filters=4, layers=[1, 1, 1, 1],
                         device="cpu")
    before = {k: v.clone() for k, v in m.net.named_parameters()}
    m.fit(X, y, X[:2], y[:2], training_cycles=3, batch_size=2,
          optimizer=compat.dummy_optimizer(), print_loss=10,
          filename=str(tmp_path / "m"))
    for k, p in m.net.named_parameters():
        assert torch.equal(p, before[k]), k
    assert isinstance(compat.dummy_optimizer()(m.net.parameters()),
                      torch.optim.Optimizer)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_channels2indices_and_combine_classes_match_jax(n_classes):
    rng = np.random.RandomState(n_classes)
    onehot = np.eye(n_classes)[rng.randint(0, n_classes, (3, 8, 8))]
    _equal(compat.channels2indices(onehot),
           jcompat.channels2indices(onehot))
    coord = _coords(1, 5, 30)
    groups = [[1, 3], [2, 4]] if n_classes == 3 else [[4, 0]]
    _equal(compat.combine_classes_(coord, groups),
           jcompat.combine_classes_(coord, groups))
