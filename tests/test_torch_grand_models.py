"""Port-only counterparts of the GRAND cases of ``tests/test_models.py``,
and the port's dropout and device placement.

Each case builds the port's model as the JAX case builds its own (the
weights from torch's seeded generator, not JAX's) and asserts the same
invariants: segment softmax sums, the row-stochastic rw adjacency,
training steps that lower the loss, the GAT attention's normalization,
rewiring and beltrami, the hard-attention and rewire_att selections with
their frozen attention, the heavy-ball and CGNN dynamics, and kNN
rewiring. Training uses ``torch.optim.Adam`` at the JAX cases' rates.
"""

import re

import numpy as np
import pytest
import torch

import pnode_tpu_torch
from pnode_tpu_torch.models.grand import (
    GATAttention, GATFunc, GRANDModel, gcn_norm_adj, gdc_rewiring,
    get_rw_adj, knn_graph, laplacian_positional_encoding, segment_softmax,
    spmm, synthetic_sbm, two_hop)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pnode_tpu_torch.clear_options()
    yield
    pnode_tpu_torch.clear_options()


def seg_sum(w, seg, n):
    return torch.zeros(n, dtype=w.dtype).index_add(0, seg, w)


def case(n=60, seed=6, n_classes=3, feat_dim=8, adj=get_rw_adj):
    data = synthetic_sbm(n_nodes=n, n_classes=n_classes, feat_dim=feat_dim,
                         seed=seed)
    return (data, adj(data["edge_index"], n), torch.as_tensor(data["x"]),
            torch.as_tensor(data["y"], dtype=torch.int64))


def model(g, **kw):
    torch.manual_seed(0)
    kw = dict(dict(T=1.0, step_size=0.5, method="rk4"), **kw)
    return GRANDModel(g, 8, 16, 3, device="cpu", **kw)


def train(m, x, y, steps, lr=1e-2, generator=None):
    """Adam steps on the mean CE (training mode); returns the losses and
    the first step's gradients."""
    opt = torch.optim.Adam(m.parameters(), lr=lr)
    losses, first = [], None
    for _ in range(steps):
        gen = (None if generator is None
               else torch.Generator().manual_seed(generator))
        loss = torch.nn.functional.cross_entropy(
            m(x, training=True, generator=gen), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if first is None:
            first = {k: None if p.grad is None else p.grad.clone()
                     for k, p in m.named_parameters()}
        opt.step()
        losses.append(float(loss.detach()))
    return losses, first


def test_grand_segment_ops():
    scores = torch.tensor([1.0, 2.0, 3.0, 0.0])
    sm = segment_softmax(scores, torch.tensor([0, 0, 1, 1]), 2)
    np.testing.assert_allclose(float(sm[0] + sm[1]), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(sm[2] + sm[3]), 1.0, rtol=1e-6)


def test_grand_rw_adj_row_stochastic():
    data = synthetic_sbm(n_nodes=50, seed=1)
    g = get_rw_adj(data["edge_index"], 50)
    src_sums = seg_sum(g.edge_weight, g.edge_index[0], 50)
    np.testing.assert_allclose(src_sums.numpy(), 1.0, rtol=1e-12)
    # A^T 1 = 1 for the row-stochastic operator applied through spmm
    ones = torch.ones(50, 1, dtype=torch.float64)
    assert spmm(g, g.edge_weight, ones).shape == (50, 1)


def test_grand_model_trains_one_step():
    data, g, x, y = case(seed=2, n_classes=4, feat_dim=32)
    torch.manual_seed(0)
    m = GRANDModel(g, 32, 16, 4, T=1.0, step_size=0.5, method="rk4",
                   device="cpu")
    losses, _ = train(m, x, y, 2, generator=0)
    assert np.all(np.isfinite(losses))


def test_grand_gat_attention_invariants():
    data, g, _, _ = case(seed=4)
    torch.manual_seed(0)
    att_mod = GATAttention(hidden_dim=16, heads=4)
    h0 = torch.as_tensor(np.random.default_rng(0).normal(
        size=(60, 16)).astype("float32"))
    att, wx = att_mod(h0, g)
    assert att.shape == (g.edge_index.shape[1], 4)
    assert wx.shape == (60, 16)
    touched = seg_sum(torch.ones(att.shape[0]), g.edge_index[0], 60) > 0
    for hd in range(4):
        sums = seg_sum(att[:, hd].detach(), g.edge_index[0], 60)
        np.testing.assert_allclose(sums[touched].numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("mix", [False, True])
def test_grand_gat_model_converges(mix):
    data, g, x, y = case(seed=5)
    m = model(g, function="gat")
    if mix:
        torch.manual_seed(1)
        m.func = GATFunc(16, heads=4, add_source=True, mix_features=True)
    losses, _ = train(m, x, y, 30, generator=0)
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.7


def test_grand_rewiring_and_beltrami():
    data, _, x, _ = case(seed=1)
    n, ei = 60, data["edge_index"]
    ei2 = two_hop(ei, n)
    s1 = {(int(a), int(b)) for a, b in zip(*ei)}
    s2 = {(int(a), int(b)) for a, b in zip(*ei2)}
    assert s1 <= s2 and len(s2) > len(s1)
    ei3, w3 = gdc_rewiring(ei, n, alpha=0.1, k=8)
    assert ei3.shape[0] == 2 and w3.shape[0] == ei3.shape[1]
    assert np.all(w3 > 0)
    assert np.bincount(ei3[0], minlength=n).max() <= 8
    pe = laplacian_positional_encoding(ei, n, dim=6)
    assert pe.shape == (60, 6) and np.all(np.isfinite(pe))

    torch.manual_seed(0)
    m = GRANDModel(get_rw_adj(ei2, n), in_dim=8, hidden_dim=16, n_classes=3,
                   function="laplacian", block="pnode", T=0.5,
                   step_size=0.25, pos_dim=6, pos_hidden=4, device="cpu")
    pe_t = torch.as_tensor(pe)
    logits = m(x, training=False, pos_encoding=pe_t)
    assert logits.shape == (60, 3)
    # the gradient reaches the beltrami encoder through the steps
    torch.mean(logits ** 2).backward()
    assert float(m.enc_pos.weight.grad.abs().sum()) > 0
    with pytest.raises(ValueError, match="pos_encoding"):
        m(x, training=False)


def test_grand_hard_attention_block():
    data, g, x, y = case(seed=6)
    m = model(g, block="hard_att", att_samp_pct=0.6)
    h0 = m.forward_encoder(x)
    w = m._hard_att_weights(h0, True).numpy()
    E = g.edge_index.shape[1]
    kept = (w > 0).sum()
    assert 0.4 * E < kept < 0.75 * E
    seg = g.edge_index[0].numpy()
    sums = np.zeros(60)
    np.add.at(sums, seg, w)
    touched = np.unique(seg[w > 0])
    np.testing.assert_allclose(sums[touched], 1.0, rtol=1e-5)
    assert (m._hard_att_weights(h0, False).numpy() > 0).all()

    losses, first = train(m, x, y, 16, generator=0)
    # the attention is frozen for the solve: no gradient reaches it
    assert all(first[k] is None or float(first[k].abs().max()) == 0.0
               for k in first if k.startswith("hard_att."))
    assert losses[-1] < losses[0]


def test_grand_heavyball_hbnode():
    data, g, x, y = case(seed=7)
    m = model(g, function="hbnode", block="heavyball")
    h = torch.as_tensor(np.random.default_rng(1).normal(
        size=(60, 16)).astype("float32"))
    st = torch.stack([h, torch.zeros_like(h)], dim=1)
    with torch.no_grad():
        f = m.func(0.0, st, g, h)
    np.testing.assert_allclose(f[:, 0].numpy(), 0.0, atol=1e-7)
    assert float(f[:, 1].abs().max()) > 0
    losses, _ = train(m, x, y, 16, generator=0)
    assert losses[-1] < losses[0]


def test_grand_cgnn_baseline():
    data, g, x, y = case(seed=8, adj=gcn_norm_adj)
    A = np.zeros((60, 60))
    src, dst = g.edge_index.numpy()
    A[src, dst] = g.edge_weight.numpy()
    np.testing.assert_allclose(A, A.T, atol=1e-12)
    m = model(g, function="cgnn", block="pnode", cgnn_alpha=0.9)
    np.testing.assert_allclose(m.func.alpha_train.detach().numpy(), 0.9,
                               rtol=1e-7)
    h = torch.as_tensor(np.random.default_rng(2).normal(
        size=(60, 32)).astype("float32"))
    with torch.no_grad():
        f = m.func(0.0, torch.zeros_like(h), g, h)
    np.testing.assert_allclose(f.numpy(), h.numpy(), rtol=1e-6)
    losses, first = train(m, x, y, 16, generator=0)
    assert float(first["func.alpha_train"].abs().max()) > 0
    assert losses[-1] < losses[0]


def test_grand_rewire_att_block():
    data, g, x, y = case(seed=6)
    m = model(g, block="rewire_att", rw_addD=0.3)
    E_base = g.edge_index.shape[1]
    cand = m.diffusion_graph.edge_index.numpy()
    E_cand = cand.shape[1]
    want = two_hop(g.edge_index.numpy(), 60)
    np.testing.assert_array_equal(np.sort(cand, axis=1),
                                  np.sort(want, axis=1))
    assert m.rewire_K == min(E_cand, round(E_base * 1.3))
    h0 = m.forward_encoder(x)
    seg = cand[0]
    for training in (True, False):
        w = m._hard_att_weights(h0, training).numpy()
        assert w.shape == (E_cand,)
        assert m.rewire_K <= int((w > 0).sum()) <= m.rewire_K + 5
        sums = np.zeros(60)
        np.add.at(sums, seg, w)
        np.testing.assert_allclose(sums[np.unique(seg[w > 0])], 1.0,
                                   rtol=1e-5)
    losses, first = train(m, x, y, 16, generator=0)
    assert all(first[k] is None or float(first[k].abs().max()) == 0.0
               for k in first if k.startswith("hard_att."))
    assert losses[-1] < losses[0]


def test_grand_knn_graph_and_rewire():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(40, 5))
    k = 4
    ei = knn_graph(pts, k)
    assert ei.shape == (2, 40 * k)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    for i in range(40):
        got = set(ei[1][ei[0] == i].tolist())
        assert len(got) == k
        cutoff = np.sort(d2[i])[k - 1]
        assert all(d2[i][j] <= cutoff + 1e-12 for j in got)

    data, g, x, _ = case(seed=6)
    m = model(g)
    with torch.no_grad():
        before = m(x, training=False)
        m.rewire(get_rw_adj(knn_graph(x, 6), 60))
        assert not m._solvers
        after = m(x, training=False)
    assert after.shape == before.shape
    assert not torch.allclose(after, before)
    m2 = model(g, block="rewire_att")
    with pytest.raises(ValueError, match="rewire"):
        m2.rewire(get_rw_adj(knn_graph(x, 6), 60))


def test_dropout_draws_from_the_generator():
    """The same generator seed gives the same masks (so the same logits
    and gradients); another seed other masks; no generator, no dropout."""
    data, g, x, y = case(seed=2)
    m = model(g)

    def logits(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return m(x, training=True, generator=gen)

    assert torch.equal(logits(5), logits(5))
    assert not torch.allclose(logits(5), logits(6))
    with torch.no_grad():
        assert torch.equal(logits(None), m(x, training=False))
    from pnode_tpu_torch.models.grand import dropout
    keep = dropout(torch.ones(1000, dtype=torch.float64), 0.5,
                   torch.Generator().manual_seed(1)) > 0
    keep32 = dropout(torch.ones(1000), 0.5,
                     torch.Generator().manual_seed(1)) > 0
    assert torch.equal(keep, keep32) and 350 < int(keep.sum()) < 650


def test_refusals_and_device():
    data, g, _, _ = case(seed=2)
    for kw, match in ((dict(function="hbnode", block="imex"), "hbnode"),
                      (dict(function="cgnn", block="imex"), "cgnn"),
                      (dict(function="gat", block="hard_att"), "hard_att"),
                      (dict(block="hard_att", att_samp_pct=0.0), "(0,1]"),
                      (dict(block="rewire_att", rw_addD=1.0), "rw_addD"),
                      (dict(function="mlp"), "unknown"),
                      (dict(pos_dim=4, pos_hidden=16), "pos_hidden")):
        with pytest.raises(ValueError, match=re.escape(match)):
            model(g, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GRANDModel(g, 8, 16, 3)
