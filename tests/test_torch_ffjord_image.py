"""The port's FFJORD image stack, the MAF loaders and the three FFJORD
drivers, on the CPU in fp64 against the JAX package.

Twins of every test of ``tests/test_ffjord_image.py``: the gated layers,
glow's BruteForceLayer, the ResNet blocks (against flax, batch statistics
included), ODENVP's and the multiscale-parallel CNF's inverse and sampling
(against JAX's inverse), and the gas / hepmass / bsds300 loaders on the
synthetic stand-in files that test writes (bit-equal to the JAX package's
loaders). Then ``examples/ffjord_tabular_torch.py``,
``ffjord_toy_torch.py`` and ``ffjord_image_torch.py`` with ``--device
cpu`` at a small size for 2 iterations: finite losses and a checkpoint
written; the image driver's surrogate bit-equal to the JAX driver's.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu.ffjord import datasets as j_datasets
from pnode_tpu.ffjord import odenvp as JO
from pnode_tpu.ffjord import other_flows as JF
from pnode_tpu.ffjord import resnet as JR
from pnode_tpu_torch import ffjord as P
from pnode_tpu_torch.ffjord import datasets as p_datasets
from pnode_tpu_torch.ffjord import layers as PL
from pnode_tpu_torch.ffjord import other_flows as PF
from pnode_tpu_torch.ffjord import resnet as PR
from pnode_tpu_torch.utils import load_checkpoint
from torch_ffjord_twins import carry, f64, rel

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port_options():
    pt.clear_options()
    yield
    pt.clear_options()


def test_gated_layers_shapes_and_gating():
    """f * sigmoid(g) vanishes with the gate pushed to -inf; the gated conv
    keeps NHWC and its transposed form doubles H and W at stride 2."""
    x = torch.randn(4, 7, dtype=F64,
                    generator=torch.Generator().manual_seed(0))
    layer = PL.GatedLinear(7, 5).to(F64)
    assert layer(x).shape == (4, 5)
    with torch.no_grad():
        layer.g.bias.fill_(-1e9)
        layer.g.weight.zero_()
    np.testing.assert_allclose(layer(x).detach().numpy(), 0.0, atol=1e-12)
    ximg = torch.randn(2, 8, 8, 3)
    assert PL.GatedConv(3, 6)(ximg).shape == (2, 8, 8, 6)
    assert PL.GatedConvTranspose(3, 6, stride=2)(ximg).shape == (2, 16, 16, 6)


def test_brute_force_layer_logdet_and_inverse():
    """delta = -log|det W| exactly, the round trip restores x and cancels
    delta; forward and reverse equal JAX's (1e-12)."""
    dim = 5
    rng = np.random.default_rng(1)
    W = np.eye(dim) + 0.3 * rng.normal(size=(dim, dim))
    x = rng.normal(size=(6, dim))
    layer = carry(PF.BruteForceLayer(dim, **CPU), {"weight": W})
    d0 = torch.zeros(6, 1, dtype=F64)
    with torch.no_grad():
        y, delta, _ = layer.apply(torch.from_numpy(x), d0, {})
        x2, delta2, _ = layer.apply(y, delta, {}, reverse=True)
    np.testing.assert_allclose(delta[:, 0].numpy(),
                               -np.linalg.slogdet(W)[1] * np.ones(6),
                               rtol=1e-6)
    np.testing.assert_allclose(x2.numpy(), x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(delta2.numpy(), 0.0, atol=1e-6)
    jl = JF.BruteForceLayer(dim)
    jy, jd, _ = jl.apply({"weight": jnp.asarray(W)}, jnp.asarray(x),
                         jnp.zeros((6, 1)), {})
    jx2, jd2, _ = jl.apply({"weight": jnp.asarray(W)}, jy, jd, {},
                           reverse=True)
    assert rel(y, jy) <= 1e-12 and rel(delta, jd) <= 1e-12
    assert rel(x2, jx2) <= 1e-12


def test_resnet_blocks():
    """BasicBlock (GroupNorm) and ResNeXtBottleneck (BatchNorm) keep the
    shape and equal flax's on its weights (1e-12): the bottleneck in
    training mode, its updated running statistics, then in eval mode."""
    x = np.random.default_rng(2).normal(size=(2, 8, 8, 4))
    jx = jnp.asarray(x)
    jb = JR.BasicBlock(dim=4)
    pb = f64(jb.init(jax.random.PRNGKey(2), jx))
    blk = carry(PR.BasicBlock(4).to(F64), pb)
    with torch.no_grad():
        y = blk(torch.from_numpy(x))
    assert y.shape == x.shape and rel(y, jb.apply(pb, jx)) <= 1e-12

    jn = JR.ResNeXtBottleneck(dim=4, cardinality=2, base_depth=8)
    variables = f64(jn.init(jax.random.PRNGKey(2), jx, training=True))
    bn_blk = carry(PR.ResNeXtBottleneck(4, cardinality=2,
                                        base_depth=8).to(F64), variables)
    jy, new_state = jn.apply(variables, jx, training=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        y = bn_blk(torch.from_numpy(x), training=True)
    assert y.shape == x.shape and rel(y, jy) <= 1e-12
    jy_eval = jn.apply({"params": variables["params"],
                        "batch_stats": new_state["batch_stats"]}, jx,
                       training=False)
    with torch.no_grad():
        y_eval = bn_blk(torch.from_numpy(x), training=False)
    assert y_eval.shape == x.shape and rel(y_eval, jy_eval) <= 1e-12


def test_odenvp_inverse_roundtrip_and_sampling():
    """Exact-divergence forward then inverse reconstructs x, delta_rev =
    -delta_fwd and log p through the inverse equals log_prob (the JAX
    test's tolerances); the inverse equals JAX's (1e-10); samples are
    finite images."""
    shape = (4, 4, 1)
    jm = JO.ODENVP(shape, n_scales=2, n_blocks=1, hidden_dims=(4,),
                   step_size=0.25)
    x = np.random.default_rng(3).uniform(0.05, 0.95, (2,) + shape)
    params = f64(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    model = carry(P.ODENVP(shape, n_scales=2, n_blocks=1, hidden_dims=(4,),
                           step_size=0.25, **CPU), params)
    with torch.no_grad():
        zs, delta = model.forward(torch.from_numpy(x), training=False)
        x2, delta_rev = model.inverse(zs)
        logpx, _ = model.log_prob(torch.from_numpy(x), training=False)
    np.testing.assert_allclose(x2.numpy(), x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(delta_rev.numpy(), -delta.numpy(), rtol=1e-4,
                               atol=1e-5)
    via_inverse = (sum(P.standard_normal_logprob(z) for z in zs)[:, None]
                   + delta_rev)
    np.testing.assert_allclose(via_inverse.numpy(), logpx.numpy(), rtol=1e-4,
                               atol=1e-4)
    jx2, jdrev = jm.inverse(params, [jnp.asarray(z.numpy()) for z in zs])
    assert rel(x2, jx2) <= 1e-10 and rel(delta_rev, jdrev) <= 1e-10
    with torch.no_grad():
        samples = model.sample(3, generator=torch.Generator().manual_seed(3))
    assert samples.shape == (3,) + shape
    assert bool(torch.isfinite(samples).all())


def test_multiscale_parallel_inverse_roundtrip():
    """The multiscale-parallel CNF's exact inverse reconstructs x (1e-4)
    and equals JAX's (1e-10); samples have x's shape."""
    shape = (4, 4, 1)
    kw = dict(n_blocks=1, intermediate_dims=(4,), alpha=0.05, step_size=0.25,
              time_length=0.5)
    jm = JO.MultiscaleParallelCNF(shape, **kw)
    x = np.random.default_rng(4).uniform(0.05, 0.95, (2,) + shape)
    params = f64(jm.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    model = carry(P.MultiscaleParallelCNF(shape, **kw, **CPU), params)
    with torch.no_grad():
        _, z = model.log_prob(torch.from_numpy(x), training=False)
        x2, _ = model.inverse(z)
    np.testing.assert_allclose(x2.numpy(), x, rtol=1e-4, atol=1e-5)
    jx2, _ = jm.inverse(params, jnp.asarray(z.numpy()))
    assert rel(x2, jx2) <= 1e-10
    with torch.no_grad():
        samples = model.sample(2, generator=torch.Generator().manual_seed(4))
    assert samples.shape == (2,) + shape


# -- MAF loaders on synthetic stand-in files ---------------------------------


def _same_splits(name, root):
    d = p_datasets.load_tabular(name, root=root)
    jd = j_datasets.load_tabular(name, root=root)
    assert d.synthetic == jd.synthetic
    for split in ("trn", "val", "tst"):
        np.testing.assert_array_equal(getattr(d, split), getattr(jd, split))
    return d


def test_gas_loader_preprocessing(tmp_path):
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    n = 400
    base = rng.normal(size=(n, 4))
    df = pd.DataFrame({
        "Time": np.arange(n, dtype=float),
        "Meth": rng.normal(size=n),
        "Eth": rng.normal(size=n),
        "A": base[:, 0],
        "B": base[:, 1],
        "C": base[:, 0] * 1.0000001 + 1e-9,  # correlated with A: pruned
        "D": base[:, 2],
        "E": base[:, 3],
    })
    os.makedirs(tmp_path / "gas", exist_ok=True)
    df.to_pickle(tmp_path / "gas" / "ethylene_CO.pickle")
    data = _same_splits("gas", str(tmp_path))
    assert not data.synthetic and data.dim == 4
    full = np.concatenate([data.trn, data.val, data.tst])
    np.testing.assert_allclose(full.mean(0), 0.0, atol=0.05)
    np.testing.assert_allclose(full.std(0), 1.0, atol=0.05)
    assert len(data.tst) == int(0.1 * n)


def test_hepmass_loader_preprocessing(tmp_path):
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(1)
    n = 300
    label = rng.integers(0, 2, n)
    feats = {f"f{i}": rng.normal(size=n) for i in range(5)}
    feats["f5"] = np.where(rng.random(n) < 0.7, 0.0, 1.0)
    df_tr = pd.DataFrame({"# label": label, **feats})
    df_te = pd.DataFrame({"# label": label, **feats, "stray": np.zeros(n)})
    os.makedirs(tmp_path / "hepmass", exist_ok=True)
    df_tr.to_csv(tmp_path / "hepmass" / "1000_train.csv", index=False)
    df_te.to_csv(tmp_path / "hepmass" / "1000_test.csv", index=False)
    data = _same_splits("hepmass", str(tmp_path))
    assert not data.synthetic and data.dim == 5
    assert len(data.trn) + len(data.val) == int((label == 1).sum())
    np.testing.assert_allclose(
        np.concatenate([data.trn, data.val]).mean(0), 0.0, atol=0.05)


def test_bsds300_loader(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(2)
    os.makedirs(tmp_path / "BSDS300", exist_ok=True)
    with h5py.File(tmp_path / "BSDS300" / "BSDS300.hdf5", "w") as f:
        f["train"] = rng.normal(size=(100, 63)).astype(np.float32)
        f["validation"] = rng.normal(size=(20, 63)).astype(np.float32)
        f["test"] = rng.normal(size=(30, 63)).astype(np.float32)
    data = _same_splits("bsds300", str(tmp_path))
    assert not data.synthetic and data.dim == 63
    assert (len(data.trn), len(data.val), len(data.tst)) == (100, 20, 30)


def test_all_five_names_resolve():
    for name in p_datasets.DATA_DIMS:
        d = p_datasets.load_tabular(name, root="/nonexistent")
        assert d.synthetic and d.dim == p_datasets.DATA_DIMS[name]


# -- the drivers --------------------------------------------------------------


def _driver(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tabular_driver_runs_on_the_cpu(tmp_path):
    """Two iterations of the power recipe at hidden 2 D with both
    regularizers, validated every iteration: finite losses, NFE-F 16 per
    iteration (rk4, 4 steps), the best checkpoint and the exact test NLL."""
    out = _driver("ffjord_tabular_torch").main([
        "--device", "cpu", "--double_prec", "--data", "power",
        "--max_iters", "2", "--val_freq", "1", "--batch_size", "500",
        "--hdim_factor", "2", "--l2int", "0.1", "--JFrobint", "0.1",
        "--save", str(tmp_path)])
    assert out["iters"] == 2 and len(out["losses"]) == 2
    assert np.all(np.isfinite(out["losses"]))
    assert out["nfe_per_iter"] == 16
    assert np.isfinite(out["test"]) and np.isfinite(out["exact_test"])
    ck = load_checkpoint(os.path.join(tmp_path, "checkpt.ckpt"))
    assert ck["itr"] in (1, 2) and np.isfinite(ck["best_val"])


def test_toy_driver_runs_on_the_cpu(tmp_path):
    out = _driver("ffjord_toy_torch").main([
        "--device", "cpu", "--niters", "2", "--batch_size", "64",
        "--dims", "16-16", "--save", str(tmp_path)])
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    ck = load_checkpoint(os.path.join(tmp_path, "checkpt.ckpt"))
    assert ck["itr"] == 2 and ck["params"]


def test_image_driver_runs_on_the_cpu_and_matches_the_surrogate(tmp_path):
    """Two iterations of ODENVP at hidden 8, B 4, on the MNIST surrogate:
    finite bits/dim, the checkpoint and a sample grid written; the
    surrogate bit-equal to the JAX driver's load_images."""
    drv = _driver("ffjord_image_torch")
    out = drv.main([
        "--device", "cpu", "--epochs", "1", "--iters_per_epoch", "2",
        "--batch_size", "4", "--hidden_dims", "8", "--n_sample", "2",
        "--data_dir", str(tmp_path / "none"), "--train_dir", str(tmp_path)])
    assert out["iters"] == 2 and np.all(np.isfinite(out["bpd"]))
    ck = load_checkpoint(os.path.join(tmp_path, "ckpt.pkl"))
    assert np.isfinite(ck["best"])
    assert np.load(os.path.join(tmp_path, "samples_ep000.npy")).shape == (
        2, 28, 28, 1)
    x, synthetic = drv.load_images("mnist", str(tmp_path / "none"))
    saved = sys.argv
    sys.argv = ["ffjord_image.py"]
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    try:
        jdrv = _driver("ffjord_image")
    finally:
        sys.argv = saved
        pnode_tpu.clear_options()
    jx, jsynthetic = jdrv.load_images("mnist", str(tmp_path / "none"))
    assert synthetic and jsynthetic
    np.testing.assert_array_equal(x, jx)
