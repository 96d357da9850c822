"""The port's GRAND stack against the JAX package's, on the CPU in fp64.

The numpy preprocessing copies (SBM graphs, rw and gcn weights, two-hop,
GDC, Laplacian PE, kNN, random extras, the Planetoid and Geom-GCN
loaders) equal their originals; the edge-list ops, attention layers and
the five dynamics match forward and VJP to rtol 1e-10; ``GRANDModel``'s
logits and its CE gradient through the port's discrete adjoint match
``jax.grad`` to rtol 1e-8 for hardware gate 6's six families,
laplacian/imex, transformer/imex, the default and beltrami, as do
``forward_ode``, ``apply_multi`` and the model after ``rewire``. Weights
are the JAX package's, carried by ``convert.grand_state_dict_from_flax``.
Tolerances are max |diff| / max |ref|.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu_torch
from pnode_tpu.models import grand as J
from pnode_tpu_torch.models import grand as P
from pnode_tpu_torch.convert import grand_state_dict_from_flax
from torch_grand_twins import (
    F64, assert_grads_match, assert_named_grads_match, carry, f64, graphs,
    holder, jax_ce, model_pair, port_ce, rel, sbm)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pnode_tpu_torch.clear_options()
    yield
    pnode_tpu_torch.clear_options()


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


# -- the numpy copies ---------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=1), dict(seed=2),
    dict(n_nodes=97, n_classes=5, feat_dim=7, p_in=0.2, p_out=0.03, seed=4),
])
def test_synthetic_sbm_bit_equal(kw):
    """The vectorized SBM draws the JAX loop's uniforms in its order."""
    a, b = J.synthetic_sbm(**kw), P.synthetic_sbm(**kw)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind, slw", [("rw", 1.0), ("rw", 0.5),
                                       ("gcn", 1.0), ("gcn", 0.0)])
def test_adjacency_weights_equal(kind, slw):
    data = sbm(n=40, seed=5)
    fj, fp = ((J.get_rw_adj, P.get_rw_adj) if kind == "rw"
              else (J.gcn_norm_adj, P.gcn_norm_adj))
    a, b = fj(data["edge_index"], 40, slw), fp(data["edge_index"], 40, slw)
    assert b.edge_index.dtype == torch.int64
    assert b.edge_weight.dtype == F64 and b.num_nodes == a.num_nodes
    np.testing.assert_array_equal(np.asarray(a.edge_index), b.edge_index)
    np.testing.assert_array_equal(np.asarray(a.edge_weight), b.edge_weight)


def test_rewiring_encodings_and_extras_equal():
    data = sbm(n=36, seed=6)
    ei, n = data["edge_index"], 36
    np.testing.assert_array_equal(J.two_hop(ei, n), P.two_hop(ei, n))
    for kw in (dict(alpha=0.1, k=8), dict(alpha=0.05, k=64),
               dict(alpha=0.1, eps=1e-3)):
        (e1, w1), (e2, w2) = J.gdc_rewiring(ei, n, **kw), \
            P.gdc_rewiring(ei, n, **kw)
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_array_equal(w1, w2)
    for dim in (6, 40):  # 40 > n - 1: zero-padded columns
        np.testing.assert_array_equal(
            J.laplacian_positional_encoding(ei, n, dim),
            P.laplacian_positional_encoding(ei, n, dim))
    pts = np.random.default_rng(3).normal(size=(30, 5))
    for k in (1, 4, 40):
        np.testing.assert_array_equal(J.knn_graph(pts, k),
                                      P.knn_graph(pts, k))
    for n_, d, s in ((60, 0.2, 0), (13, 0.5, 3)):
        np.testing.assert_array_equal(J.random_extra_edges(n_, d, s),
                                      P.random_extra_edges(n_, d, s))
    w = np.random.default_rng(1).random(ei.shape[1])
    for a, b in zip(J.add_self_loops(ei, n, 0.3, w),
                    P.add_self_loops(ei, n, 0.3, w)):
        np.testing.assert_array_equal(a, b)


def _write_planetoid(path, name, rng, gapped):
    n_train, n_extra, n_test, f, c = 6, 8, 4, 5, 3
    base = n_train + n_extra
    x = rng.normal(size=(n_train, f)).astype(np.float32)
    allx = np.concatenate([x, rng.normal(size=(n_extra, f)).astype(
        np.float32)])
    tx = rng.normal(size=(n_test, f)).astype(np.float32)

    def onehot(k):
        lab = rng.integers(0, c, k)
        out = np.zeros((k, c), np.int64)
        out[np.arange(k), lab] = 1
        return out

    y = onehot(n_train)
    ally = np.concatenate([y, onehot(n_extra)])
    ty = onehot(n_test)
    test_idx = (np.asarray([base, base + 2, base + 3, base + 6]) if gapped
                else np.arange(base, base + n_test))
    n_full = int(test_idx.max()) + 1
    graph = {i: [int(j) for j in rng.integers(0, n_full, 2)]
             for i in range(n_full)}
    rng.shuffle(test_idx)
    parts = {"x": x, "tx": tx, "allx": allx, "y": y, "ty": ty,
             "ally": ally, "graph": graph}
    for part, obj in parts.items():
        with open(path / f"ind.{name}.{part}", "wb") as fh:
            pickle.dump(obj, fh)
    np.savetxt(path / f"ind.{name}.test.index", test_idx, fmt="%d")


def _write_heterophilic(base, fields, labels, edges, split, n):
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "out1_node_feature_label.txt"), "w") as f:
        f.write("node_id\tfeature\tlabel\n")
        for i, (fs, lab) in enumerate(zip(fields, labels)):
            f.write(f"{i}\t{fs}\t{lab}\n")
    with open(os.path.join(base, "out1_graph_edges.txt"), "w") as f:
        f.write("src\tdst\n")
        for a, b in edges:
            f.write(f"{a}\t{b}\n")
    tr = np.zeros(n, bool)
    tr[: n // 2] = True
    name = os.path.basename(base)
    np.savez(os.path.join(base, f"{name}_split_0.6_0.2_{split}.npz"),
             train_mask=tr, val_mask=~tr, test_mask=np.zeros(n, bool))


def _same_dataset(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name, gapped", [("cora", False),
                                          ("citeseer", True)])
def test_planetoid_loader_equal(tmp_path, name, gapped):
    _write_planetoid(tmp_path, name, np.random.default_rng(1), gapped)
    _same_dataset(J.load_planetoid(str(tmp_path), name),
                  P.load_planetoid(str(tmp_path), name))
    with pytest.raises(FileNotFoundError):
        P.load_planetoid(str(tmp_path), "pubmed")


def test_heterophilic_loader_equal(tmp_path):
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(5, 3)).astype(np.float32)
    fields = [",".join(f"{v:.6f}" for v in row) for row in feats]
    edges = [(0, 1), (1, 0), (2, 2), (3, 4), (1, 2), (1, 2)]
    _write_heterophilic(str(tmp_path / "cornell"), fields, [0, 1, 1, 0, 1],
                        edges, 0, 5)
    _write_heterophilic(str(tmp_path / "film"), ["0,5,931", "7", "3,4"],
                        [1, 3, 2], [(0, 1), (2, 1)], 3, 3)
    for name, split in (("cornell", 0), ("film", 3)):
        _same_dataset(J.load_heterophilic(str(tmp_path), name, split),
                      P.load_heterophilic(str(tmp_path), name, split))


# -- edge-list ops ------------------------------------------------------------


def _edges(n=30, seed=7):
    data = sbm(n=n, seed=seed)
    return graphs(data)


def test_spmm_forward_and_vjp():
    jg, pg = _edges()
    rng = np.random.default_rng(0)
    E = pg.edge_index.shape[1]
    w, x, ct = rng.random(E), rng.normal(size=(30, 5)), rng.normal(
        size=(30, 5))
    out, vjp = jax.vjp(lambda ww, xx: J.spmm(jg, ww, xx), jnp.asarray(w),
                       jnp.asarray(x))
    gw, gx = vjp(jnp.asarray(ct))
    wt, xt = t64(w).requires_grad_(), t64(x).requires_grad_()
    got = P.spmm(pg, wt, xt)
    assert rel(got, out) <= 1e-10
    g2w, g2x = torch.autograd.grad(got, [wt, xt], t64(ct))
    assert rel(g2w, gw) <= 1e-10 and rel(g2x, gx) <= 1e-10
    # the graph's own fp64 weights, cast to the state's dtype at use
    assert P.spmm(pg, pg.edge_weight, xt.float()).dtype == torch.float32


@pytest.mark.parametrize("heads", [0, 4])
def test_segment_softmax_forward_and_vjp(heads):
    """All heads in one pass against JAX's vmap over heads; the max is
    detached, the gradient JAX's to rounding."""
    jg, pg = _edges()
    seg = np.asarray(jg.edge_index[0])
    E = seg.shape[0]
    shape = (E,) if heads == 0 else (E, heads)
    rng = np.random.default_rng(1)
    s, ct = 3.0 * rng.normal(size=shape), rng.normal(size=shape)

    def jsm(ss):
        if heads == 0:
            return J.segment_softmax(ss, jnp.asarray(seg), 30)
        return jax.vmap(lambda c: J.segment_softmax(c, jnp.asarray(seg), 30),
                        in_axes=1, out_axes=1)(ss)

    out, vjp = jax.vjp(jsm, jnp.asarray(s))
    st = t64(s).requires_grad_()
    got = P.segment_softmax(st, torch.as_tensor(np.array(seg)), 30)
    assert rel(got, out) <= 1e-10
    (g,) = torch.autograd.grad(got, [st], t64(ct))
    assert rel(g, vjp(jnp.asarray(ct))[0]) <= 1e-10


def test_attention_weight_selections_equal():
    """renormalise_attention (forward and VJP), the hard-attention quantile
    threshold (linear interpolation, strict >) and the top-k selection
    (ties at the k-th kept) against JAX."""
    jg, pg = _edges()
    rng = np.random.default_rng(2)
    E = pg.edge_index.shape[1]
    w, ct = rng.random(E), rng.normal(size=E)
    jei = jg.edge_index
    for norm_idx in (0, 1):
        out, vjp = jax.vjp(lambda ww: J.renormalise_attention(
            ww, jei, 30, norm_idx), jnp.asarray(w))
        wt = t64(w).requires_grad_()
        got = P.renormalise_attention(wt, pg.edge_index, 30, norm_idx)
        assert rel(got, out) <= 1e-10
        (g,) = torch.autograd.grad(got, [wt], t64(ct))
        assert rel(g, vjp(jnp.asarray(ct))[0]) <= 1e-10
        for pct in (0.25, 0.6, 1.0):
            a = J.hard_attention_weights(jnp.asarray(w), jei, 30, pct,
                                         norm_idx)
            b = P.hard_attention_weights(t64(w), pg.edge_index, 30, pct,
                                         norm_idx)
            assert rel(b, a) <= 1e-10
            np.testing.assert_array_equal(np.asarray(a) > 0, b.numpy() > 0)
        tied = np.round(w * 8) / 8  # many ties at the k-th score
        for k in (1, E // 3, E):
            a = J.rewire_topk_weights(jnp.asarray(tied), jei, 30, k,
                                      norm_idx)
            b = P.rewire_topk_weights(t64(tied), pg.edge_index, 30, k,
                                      norm_idx)
            assert rel(b, a) <= 1e-10
            np.testing.assert_array_equal(np.asarray(a) > 0, b.numpy() > 0)


# -- attention layers and dynamics --------------------------------------------


def _dyn_case(n=30, h=16, seed=8):
    data = sbm(n=n, seed=seed)
    jg, pg = graphs(data)
    rng = np.random.default_rng(seed)
    x, x0 = rng.normal(size=(n, h)), rng.normal(size=(n, h))
    return jg, pg, x, x0, rng


def _layer_twin(jmod, pmod, args_j, args_p, jvars, outs=lambda o: o):
    """Forward and VJP (to the parameters and the float inputs) of a flax
    layer and its port twin, at rtol 1e-10."""
    jvars = f64(jvars)
    port = carry(holder(m=pmod), {"m": jvars}).m
    floats = [i for i, a in enumerate(args_j) if isinstance(a, jnp.ndarray)
              and jnp.issubdtype(a.dtype, jnp.floating)]

    def jf(p, *fl):
        a = list(args_j)
        for i, v in zip(floats, fl):
            a[i] = v
        return outs(jmod.apply(p, *a))

    out, vjp = jax.vjp(jf, jvars, *[args_j[i] for i in floats])
    pa = list(args_p)
    for i in floats:
        pa[i] = pa[i].detach().requires_grad_()
    got = outs(port(*pa))
    leaves_j, leaves_p = jax.tree_util.tree_leaves(out), (
        list(got) if isinstance(got, tuple) else [got])
    for a, b in zip(leaves_j, leaves_p):
        assert rel(b, a) <= 1e-10
    rng = np.random.default_rng(9)
    cts = [rng.normal(size=np.shape(a)) for a in leaves_j]
    gj = vjp(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(out), [jnp.asarray(c) for c in cts]))
    params = dict(port.named_parameters())
    gp = torch.autograd.grad(
        leaves_p, list(params.values()) + [pa[i] for i in floats],
        [t64(c) for c in cts], allow_unused=True)
    ref = grand_state_dict_from_flax(holder(m=port), {"m": f64(gj[0])})
    assert_named_grads_match(
        {"m." + name: g for name, g in zip(params, gp)}, ref, 1e-10)
    for g, r in zip(gp[len(params):], gj[1:]):  # None: an unused input
        assert rel(torch.zeros(r.shape, dtype=F64) if g is None else g,
                   r) <= 1e-10 or not np.any(np.asarray(r))


@pytest.mark.parametrize("norm_idx", [0, 1])
def test_trans_attention_twin(norm_idx):
    jg, pg, x, _, _ = _dyn_case()
    jm = J.TransAttention(16, heads=4, norm_idx=norm_idx)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    _layer_twin(jm, P.TransAttention(16, 4, norm_idx), (jnp.asarray(x), jg),
                (t64(x), pg), v)


def test_gat_attention_twin():
    jg, pg, x, _, _ = _dyn_case()
    jm = J.GATAttention(16, heads=4)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jg)
    _layer_twin(jm, P.GATAttention(16, heads=4), (jnp.asarray(x), jg),
                (t64(x), pg), v)


def _dynamics(name, n, h):
    if name == "laplacian":
        return J.LaplacianFunc(h), P.LaplacianFunc(h)
    if name == "laplacian_att_w":
        return J.LaplacianFunc(h), P.LaplacianFunc(h)
    if name == "attention":
        return J.AttentionFunc(h, heads=4), P.AttentionFunc(h, heads=4)
    if name == "gat":
        return J.GATFunc(h, heads=4), P.GATFunc(h, heads=4)
    if name == "gat_mix":
        return (J.GATFunc(h, heads=4, mix_features=True),
                P.GATFunc(h, heads=4, mix_features=True))
    if name == "heavyball":
        return J.HeavyBallFunc(h), P.HeavyBallFunc(h)
    return J.CGNNFunc(alpha_init=0.9), P.CGNNFunc(n, alpha_init=0.9)


@pytest.mark.parametrize("name", ["laplacian", "laplacian_att_w",
                                  "attention", "gat", "gat_mix",
                                  "heavyball", "cgnn"])
def test_dynamics_twin(name):
    """Each dynamics' f(t, x, graph, x0) and its VJP to the parameters, x
    and x0; CGNN on the gcn adjacency, heavy-ball on the (N, 2, H)
    state."""
    n, h = 30, 16
    jg, pg, x, x0, rng = _dyn_case(n, h)
    if name == "cgnn":
        jg, pg = graphs(sbm(n=n, seed=8), "gcn")
    if name == "heavyball":
        x = rng.normal(size=(n, 2, h))
    jm, pm = _dynamics(name, n, h)
    args_j = [0.0, jnp.asarray(x), jg, jnp.asarray(x0)]
    args_p = [0.0, t64(x), pg, t64(x0)]
    if name == "laplacian_att_w":
        w = rng.random(pg.edge_index.shape[1])
        args_j.append(jnp.asarray(w))
        args_p.append(t64(w))
    v = jm.init(jax.random.PRNGKey(2), *args_j)
    if name in ("laplacian", "laplacian_att_w", "cgnn"):
        # move the scalars off their init so alpha, beta and x0 all count
        v = jax.tree_util.tree_map(lambda a: a * 0.7 + 0.1, v)
    _layer_twin(jm, pm, tuple(args_j), tuple(args_p), v)


# -- the model ----------------------------------------------------------------

FAMILIES = {  # hardware gate 6's six families, and more blocks
    "transformer/pnode": dict(function="transformer"),
    "gat/pnode": dict(function="gat"),
    "hbnode/heavyball": dict(function="hbnode", block="heavyball"),
    "cgnn/pnode": dict(function="cgnn", cgnn_alpha=0.9),
    "laplacian/hard_att": dict(function="laplacian", block="hard_att",
                               att_samp_pct=0.7),
    "laplacian/rewire_att": dict(function="laplacian", block="rewire_att",
                                 rw_addD=0.25),
    "laplacian/imex": dict(function="laplacian", block="imex"),
    "transformer/imex": dict(function="transformer", block="imex"),
    "laplacian/pnode rk4": dict(function="laplacian", method="rk4",
                                step_size=0.5),
    "laplacian/hard_att flux norm1": dict(
        function="laplacian", block="hard_att", att_samp_pct=0.6,
        use_flux=True, attention_norm_idx=1),
    "laplacian/rewire_att random": dict(
        function="laplacian", block="rewire_att", rw_addD=0.3,
        rewire_candidates="random", rewire_seed=2),
}


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_model_ce_gradient_through_adjoint_matches_jax(fam):
    """Logits (training and eval mode) and the CE gradient of every
    parameter through the port's discrete adjoint against jax.grad, at rtol
    1e-8 (dropout off: no generator, JAX's rng None)."""
    data = sbm()
    jm, params, pm = model_pair(data, **FAMILIES[fam])
    x = jnp.asarray(data["x"], jnp.float64)
    xt = torch.as_tensor(data["x"], dtype=F64)
    with torch.no_grad():
        for training in (True, False):
            assert rel(pm(xt, training=training),
                       jm.apply(params, x, training=training)) <= 1e-10
    jl, jgrad = jax_ce(jm, params, data)
    pl = port_ce(pm, data)
    assert abs(pl - float(jl)) <= 1e-12 * abs(float(jl))
    assert_grads_match(pm, jgrad, 1e-8)


def test_beltrami_model_matches_jax():
    """Beltrami mode: the positional encoder's gradient too, in training
    and evaluation mode (autograd through the steps)."""
    data = sbm()
    pe = J.laplacian_positional_encoding(data["edge_index"], 48, 6)
    jm, params, pm = model_pair(data, pos_enc=jnp.asarray(pe, jnp.float64),
                                function="laplacian", pos_dim=6,
                                pos_hidden=4, T=0.5)
    pe64 = jnp.asarray(pe, jnp.float64)
    for training in (True, False):
        jl, jgrad = jax_ce(jm, params, data, training, pe64)
        pl = port_ce(pm, data, training, pe)
        assert abs(pl - float(jl)) <= 1e-12 * abs(float(jl))
        assert_grads_match(pm, jgrad, 1e-8)
    assert float(pm.enc_pos.weight.grad.abs().sum()) > 0


def test_forward_ode_apply_multi_and_encoder_match_jax():
    """forward_encoder, forward_ode, and apply_multi at several times (its
    first time is the solve's start, as in the JAX package)."""
    data = sbm()
    for fam in ("transformer/imex", "hbnode/heavyball", "cgnn/pnode",
                "laplacian/hard_att"):
        jm, params, pm = model_pair(data, **FAMILIES[fam])
        x = jnp.asarray(data["x"], jnp.float64)
        xt = torch.as_tensor(data["x"], dtype=F64)
        times = np.linspace(0.0, 1.0, 5)[1:]
        with torch.no_grad():
            assert rel(pm.forward_encoder(xt),
                       jm.forward_encoder(params, x)) <= 1e-12
            assert rel(pm.forward_ode(xt),
                       jm.forward_ode(params, x)) <= 1e-10
            got = pm.apply_multi(xt, times)
        ref = jm.apply_multi(params, x, times)
        assert got.shape == ref.shape == (4, 48, 3)
        assert rel(got, ref) <= 1e-10, fam


def test_model_after_knn_rewire_matches_jax():
    data = sbm()
    jm, params, pm = model_pair(data, function="transformer")
    x = jnp.asarray(data["x"], jnp.float64)
    xt = torch.as_tensor(data["x"], dtype=F64)
    pm(xt, training=False)  # a cached solver, which rewire() drops
    ei_j = J.knn_graph(np.asarray(jm.forward_encoder(params, x)), 5)
    with torch.no_grad():
        ei_p = P.knn_graph(pm.forward_encoder(xt), 5)
    np.testing.assert_array_equal(ei_j, ei_p)
    jm.rewire(J.get_rw_adj(ei_j, 48))
    pm.rewire(P.get_rw_adj(ei_p, 48))
    assert not pm._solvers
    jl, jgrad = jax_ce(jm, params, data)
    pl = port_ce(pm, data)
    assert abs(pl - float(jl)) <= 1e-12 * abs(float(jl))
    assert_grads_match(pm, jgrad, 1e-8)


def test_source_cotangent_is_zero_and_imex_alpha_sums_both_parts():
    """x0 and att_w are detached inside the dynamics (JAX's stop_gradient):
    the adjoint's cotangent for x0 is exactly 0, so the encoder's gradient
    comes through y0 alone. The IMEX block hands one parameter dict to
    both parts: alpha's gradient is the sum over f_IM and f_EX (JAX's
    p = (p, p))."""
    data = sbm()
    _, _, pm = model_pair(data, function="laplacian", block="imex")
    xt = torch.as_tensor(data["x"], dtype=F64)
    h0 = pm.forward_encoder(xt).detach()
    y0 = h0.clone().requires_grad_()
    x0 = h0.clone().requires_grad_()
    ode = pm._get_solver(tuple(h0.shape), F64, True)
    t = np.array([0.0, 1.0])
    p = dict(pm.func.named_parameters())
    p["x0"] = x0
    sol, _ = ode.solve(y0, t, params=(p, p), with_adjoint=True)
    gy, gx0, ga = torch.autograd.grad(sol[-1].sum(),
                                      [y0, x0, pm.func.alpha_train])
    assert float(gy.abs().max()) > 0
    assert float(gx0.abs().max()) == 0.0
    # alpha as two leaves, one a part: their gradients add up to the shared
    a_im, a_ex = (pm.func.alpha_train.detach().clone().requires_grad_()
                  for _ in range(2))
    sol, _ = ode.solve(y0, t, params=(dict(p, alpha_train=a_im),
                                      dict(p, alpha_train=a_ex)),
                       with_adjoint=True)
    g_im, g_ex = torch.autograd.grad(sol[-1].sum(), [a_im, a_ex])
    assert abs(float(g_im + g_ex - ga)) <= 1e-12 * abs(float(ga))
    assert float(g_im.abs()) > 0 and float(g_ex.abs()) > 0


def test_public_names_match_the_jax_package():
    """Every public name of the JAX modules has a counterpart in the
    port."""
    from pnode_tpu.models import grand_image as JI
    from pnode_tpu_torch.models import grand_image as PI

    for jmod, pmod in ((J, P), (JI, PI)):
        names = {n for n, v in vars(jmod).items() if not n.startswith("_")
                 and getattr(v, "__module__", None) == jmod.__name__}
        missing = sorted(n for n in names if not hasattr(pmod, n))
        assert not missing, missing
