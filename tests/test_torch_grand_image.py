"""The port's GRANDImage against the JAX package's on the CPU in fp64, and
port-only counterparts of ``tests/test_grand_image.py``.

``grid_edge_index`` equals its original; GRANDImage's logits and its CE
gradient through the port's discrete adjoint match ``jax.grad`` to rtol
1e-8 with rk4 and with dopri5 (the single output time T: the solver
integrates [0, T] and returns the endpoint).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu_torch
from pnode_tpu.models.grand_image import GRANDImage as JGRANDImage
from pnode_tpu.models.grand_image import grid_edge_index as j_grid
from pnode_tpu_torch.models.grand import load_heterophilic
from pnode_tpu_torch.models.grand_image import GRANDImage, grid_edge_index
from torch_grand_twins import CPU, F64, assert_grads_match, carry, f64, rel

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pnode_tpu_torch.clear_options()
    yield
    pnode_tpu_torch.clear_options()


def blobs(B=32, H=8, W=8, n_cls=4, seed=0):
    """tests/test_grand_image.py's quadrant-blob batch."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, n_cls, size=B)
    xs = np.zeros((B, H, W, 1), np.float32)
    for i, c in enumerate(ys):
        oy, ox = (c // 2) * (H // 2), (c % 2) * (W // 2)
        xs[i, oy + 1: oy + 3, ox + 1: ox + 3, 0] = 1.0
    xs += rng.normal(scale=0.15, size=xs.shape).astype(np.float32)
    return xs, ys


@pytest.mark.parametrize("H, W", [(4, 4), (5, 3), (8, 8), (1, 6)])
@pytest.mark.parametrize("diags", [False, True])
def test_grid_edge_index_equal(H, W, diags):
    np.testing.assert_array_equal(j_grid(H, W, diags),
                                  grid_edge_index(H, W, diags))


@pytest.mark.parametrize("method, chan", [("rk4", 1), ("dopri5", 1),
                                          ("rk4", 2)])
def test_grand_image_gradient_through_adjoint_matches_jax(method, chan):
    """Logits in both modes and the CE gradient through the discrete
    adjoint (the source x0 not detached, as in the JAX package) against
    jax.grad at rtol 1e-8, dropout off."""
    xs, ys = blobs(B=6, H=5, W=4)
    if chan == 2:
        xs = np.concatenate([xs, 0.5 * xs[..., ::-1, :]], axis=-1)
    kw = dict(T=1.0, step_size=0.25, method=method, chan=chan,
              input_dropout=0.0, dropout=0.0)
    jm = JGRANDImage(5, 4, 4, **kw)
    x = jnp.asarray(xs, jnp.float64)
    params = f64(jm.init(jax.random.PRNGKey(1), x))
    pm = carry(GRANDImage(5, 4, 4, **kw, **CPU), params)
    xt = torch.as_tensor(xs, dtype=F64)
    with torch.no_grad():
        for training in (True, False):
            assert rel(pm(xt, training=training),
                       jm.apply(params, x, training=training)) <= 1e-10

    def loss(p):
        lg = jm.apply(p, x, training=True)
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(lg), jnp.asarray(ys)[:, None], 1))

    jl, jg = jax.value_and_grad(loss)(params)
    pl = torch.nn.functional.cross_entropy(
        pm(xt, training=True), torch.as_tensor(ys, dtype=torch.int64))
    pl.backward()
    assert abs(float(pl.detach()) - float(jl)) <= 1e-12 * abs(float(jl))
    assert_grads_match(pm, jg, 1e-8)


# -- port-only counterparts of tests/test_grand_image.py ----------------------


@pytest.mark.parametrize("H, W", [(4, 4), (5, 3), (8, 8)])
def test_grid_edge_counts(H, W):
    """2 (2HW - H - W) edges without diagonals, 4 (H-1)(W-1) more with;
    both directions present, no self loops."""
    e = grid_edge_index(H, W, diags=False)
    assert e.shape[1] == 2 * (2 * H * W - H - W)
    ed = grid_edge_index(H, W, diags=True)
    assert ed.shape[1] == 2 * (2 * H * W - H - W) + 4 * (H - 1) * (W - 1)
    s = {(int(a), int(b)) for a, b in ed.T}
    assert all((b, a) in s for a, b in s)
    assert all(a != b for a, b in s)


def test_grand_image_trains():
    """The quadrant-blob task: the loss falls by half and accuracy passes
    chance (Adam 5e-2, rk4, as the JAX test trains)."""
    xs, ys = blobs(B=64)
    torch.manual_seed(0)
    model = GRANDImage(8, 8, 4, T=1.0, step_size=0.25, method="rk4",
                       input_dropout=0.0, dropout=0.0, device="cpu")
    x, y = torch.as_tensor(xs), torch.as_tensor(ys, dtype=torch.int64)
    opt = torch.optim.Adam(model.parameters(), lr=5e-2)
    losses = []
    for _ in range(60):
        loss = torch.nn.functional.cross_entropy(model(x, training=True), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.5
    with torch.no_grad():
        acc = float((model(x).argmax(-1) == y).float().mean())
    assert acc > 0.5, acc


def test_grand_image_dropout_and_device():
    """Dropout draws from the generator (the same seed, the same logits;
    none without one) and a CUDA device without CUDA raises."""
    xs, _ = blobs(B=4)
    torch.manual_seed(0)
    model = GRANDImage(8, 8, 4, method="rk4", device="cpu")
    x = torch.as_tensor(xs)
    with torch.no_grad():
        a = model(x, training=True, generator=torch.Generator().manual_seed(3))
        b = model(x, training=True, generator=torch.Generator().manual_seed(3))
        c = model(x, training=True, generator=torch.Generator().manual_seed(4))
        plain = model(x, training=True)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert torch.equal(plain, model(x, training=False))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GRANDImage(8, 8, 4, device="cuda")


def test_heterophilic_loader(tmp_path):
    """Geom-GCN raw format: dense and multi-hot (film) features,
    undirected coalesced edges, npz split masks."""
    d = tmp_path / "cornell"
    os.makedirs(d)
    with open(d / "out1_node_feature_label.txt", "w") as f:
        f.write("node_id\tfeature\tlabel\n")
        f.write("0\t1,0,1\t0\n1\t0,1,0\t1\n2\t1,1,0\t2\n3\t0,0,1\t1\n")
    with open(d / "out1_graph_edges.txt", "w") as f:
        f.write("src\tdst\n0\t1\n1\t0\n1\t2\n2\t3\n2\t2\n1\t2\n")
    np.savez(d / "cornell_split_0.6_0.2_0.npz",
             train_mask=np.array([1, 1, 0, 0], bool),
             val_mask=np.array([0, 0, 1, 0], bool),
             test_mask=np.array([0, 0, 0, 1], bool))
    data = load_heterophilic(str(tmp_path), "cornell", split=0)
    assert data["x"].shape == (4, 3)
    np.testing.assert_array_equal(data["y"], [0, 1, 2, 1])
    e = {(int(a), int(b)) for a, b in data["edge_index"].T}
    assert e == {(0, 1), (1, 0), (1, 2), (2, 1), (2, 3), (3, 2)}
    assert data["train_mask"].sum() == 2

    d2 = tmp_path / "film"
    os.makedirs(d2)
    with open(d2 / "out1_node_feature_label.txt", "w") as f:
        f.write("node_id\tfeature\tlabel\n")
        f.write("0\t3,10\t4\n1\t0\t2\n")
    with open(d2 / "out1_graph_edges.txt", "w") as f:
        f.write("src\tdst\n0\t1\n")
    np.savez(d2 / "film_split_0.6_0.2_0.npz",
             train_mask=np.array([1, 0], bool),
             val_mask=np.array([0, 1], bool),
             test_mask=np.array([0, 0], bool))
    data = load_heterophilic(str(tmp_path), "film", split=0)
    assert data["x"].shape == (2, 932)
    assert data["x"][0, 3] == 1.0 and data["x"][0, 10] == 1.0
    assert data["x"].sum() == 3.0
    np.testing.assert_array_equal(data["y"], [4, 2])
