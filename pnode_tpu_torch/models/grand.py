"""GRAND: graph neural diffusion as a neural ODE (PyTorch).

Counterpart of ``pnode_tpu/models/grand.py``: node features diffuse under
du/dt = alpha (A u - u) (+ beta u0), where A is the rw-normalized
adjacency (``LaplacianFunc``), a multi-head scaled-dot transformer
attention recomputed at every evaluation (``AttentionFunc``), or additive
GAT attention (``GATFunc``); ``HeavyBallFunc`` and ``CGNNFunc`` are the
momentum and continuous-GNN baselines. ``GRANDModel`` wraps encoder ->
diffusion block -> decoder and integrates with the port's discrete-adjoint
``ODESolver``; the IMEX block treats -sigmoid(alpha) y implicitly (Newton
on GMRES) with the rest explicit.

Sparse ops are edge-list based, on the graph's int64 ``edge_index``:
``spmm`` gathers the weighted source features and sums them into their
destinations with ``index_add``; ``segment_softmax`` takes each segment's
max with ``scatter_reduce("amax")`` (detached: softmax does not change when
its inputs are shifted), exponentiates and normalizes by an ``index_add``
sum, over all heads of an (E, heads) score in one pass. On CUDA,
``index_add`` sums by atomics, so fp32 results vary in their last bits
from run to run.

The graph preprocessing (``add_self_loops`` ... ``load_heterophilic``) is
numpy, a copy of the JAX package's: ``Graph`` holds ``edge_index`` as an
int64 tensor and the edge weights in fp64, as they are built on the host;
they are cast to the state's dtype where they are used.

Weights are drawn as flax draws them (LeCun-normal Dense kernels with zero
biases, fan-avg uniform attention projections, glorot-normal GAT weights,
ones for alpha and beta, -3 for gamma), on the CPU from torch's generator,
then moved to ``device``; ``convert.grand_state_dict_from_flax`` carries the
JAX package's instead. Dropout draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ffjord.layers import dense, fan_avg_, on_device
from ..solver import ODESolver


class Graph(NamedTuple):
    edge_index: torch.Tensor   # (2, E) int64 [src, dst]
    edge_weight: torch.Tensor  # (E,) fp64
    num_nodes: int

    def to(self, device) -> "Graph":
        return Graph(self.edge_index.to(device), self.edge_weight.to(device),
                     self.num_nodes)


def _graph(ei, w, num_nodes) -> Graph:
    return Graph(torch.as_tensor(np.asarray(ei), dtype=torch.int64),
                 torch.as_tensor(np.asarray(w), dtype=torch.float64),
                 int(num_nodes))


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# -- graph preprocessing (numpy; copies of the JAX package's) -----------------


def add_self_loops(edge_index, num_nodes, fill_value=1.0, edge_weight=None):
    E = edge_index.shape[1]
    loops = np.stack([np.arange(num_nodes)] * 2)
    ei = np.concatenate([_np(edge_index), loops], axis=1)
    ew = np.concatenate([
        np.ones(E) if edge_weight is None else _np(edge_weight),
        np.full(num_nodes, fill_value),
    ])
    return ei, ew


def get_rw_adj(edge_index, num_nodes, self_loop_weight=1.0):
    """Row-normalized random-walk adjacency with self loops
    (grand/src/utils.py get_rw_adj, norm_dim=1)."""
    ei, ew = add_self_loops(edge_index, num_nodes, self_loop_weight)
    src, dst = ei
    deg = np.zeros(num_nodes)
    np.add.at(deg, src, ew)
    w = ew / np.maximum(deg[src], 1e-12)
    return _graph(ei, w, num_nodes)


def gcn_norm_adj(edge_index, num_nodes, self_loop_weight=1.0):
    """Symmetrically-normalized adjacency D^-1/2 (A + w I) D^-1/2 (the
    CGNN baseline's operator, degree accumulated over the dst column)."""
    if self_loop_weight:
        ei, ew = add_self_loops(edge_index, num_nodes, self_loop_weight)
    else:
        ei = _np(edge_index)
        ew = np.ones(ei.shape[1])
    src, dst = ei
    deg = np.zeros(num_nodes)
    np.add.at(deg, dst, ew)
    dis = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    return _graph(ei, dis[src] * ew * dis[dst], num_nodes)


def two_hop(edge_index, num_nodes):
    """Add all 2-hop edges (the reference's TwoHop rewiring). Dense boolean
    adjacency product: host-side preprocessing at Cora scale."""
    ei = _np(edge_index)
    A = np.zeros((num_nodes, num_nodes), dtype=bool)
    A[ei[0], ei[1]] = True
    A2 = (A.astype(np.int32) @ A.astype(np.int32)) > 0
    np.fill_diagonal(A2, False)
    merged = A | A2
    src, dst = np.nonzero(merged)
    return np.stack([src, dst])


def gdc_rewiring(edge_index, num_nodes, alpha=0.05, k=64, eps=None,
                 self_loop_weight=1.0):
    """Graph diffusion convolution (PPR) rewiring: S = a (I-(1-a)T)^-1 on
    the sym-normalized adjacency, sparsified by exact top-k per column (or
    the threshold eps), column-normalized. Returns (edge_index,
    edge_weight)."""
    ei, ew = add_self_loops(edge_index, num_nodes, self_loop_weight)
    A = np.zeros((num_nodes, num_nodes))
    A[ei[0], ei[1]] += ew
    deg = np.maximum(A.sum(axis=1), 1e-12)
    Dm = 1.0 / np.sqrt(deg)
    T = Dm[:, None] * A * Dm[None, :]
    S = alpha * np.linalg.inv(np.eye(num_nodes) - (1 - alpha) * T)
    if eps is not None:
        S[S < eps] = 0.0
    else:
        kk = min(int(k), num_nodes)
        keep = np.argpartition(S, -kk, axis=0)[-kk:]
        mask = np.zeros_like(S, dtype=bool)
        mask[keep, np.arange(S.shape[1])[None, :]] = True
        S[~mask] = 0.0
    colsum = np.maximum(S.sum(axis=0), 1e-12)
    S = S / colsum[None, :]
    src, dst = np.nonzero(S.T)  # edges src->dst with weight S[dst, src]
    w = S[dst, src]
    return np.stack([src, dst]), w


def laplacian_positional_encoding(edge_index, num_nodes, dim):
    """Symmetric-Laplacian eigenvector positional encodings for beltrami
    mode (the smallest nontrivial eigenvectors, sign-fixed)."""
    ei = _np(edge_index)
    A = np.zeros((num_nodes, num_nodes))
    A[ei[0], ei[1]] = 1.0
    A = np.maximum(A, A.T)
    deg = np.maximum(A.sum(1), 1e-12)
    Dm = 1.0 / np.sqrt(deg)
    L = np.eye(num_nodes) - Dm[:, None] * A * Dm[None, :]
    vals, vecs = np.linalg.eigh(L)
    pe = vecs[:, 1:dim + 1]
    signs = np.sign(pe[np.argmax(np.abs(pe), axis=0), np.arange(pe.shape[1])])
    pe = pe * np.where(signs == 0, 1.0, signs)[None, :]
    if pe.shape[1] < dim:
        pe = np.pad(pe, ((0, 0), (0, dim - pe.shape[1])))
    return pe.astype(np.float32)


def random_extra_edges(num_nodes, rw_addD, seed=0):
    """The rewire_att block's random candidate pool: M = N (1/(1-rw_addD)
    - 1) uniformly random directed edges, sampled once at setup."""
    M = max(1, int(num_nodes * (1.0 / (1.0 - rw_addD) - 1.0)))
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_nodes, size=(2, M))


def knn_graph(x, k):
    """Feature-space kNN edges: node i connects to its k nearest neighbors
    by euclidean distance (self included). Exactly N*k edges, so a rewired
    graph keeps its shape."""
    x = _np(x)
    n = x.shape[0]
    k = min(int(k), n)
    sq = (x * x).sum(axis=1)
    d2 = sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]
    idx = np.argpartition(d2, kth=k - 1, axis=1)[:, :k]
    src = np.repeat(np.arange(n), k)
    return np.stack([src, idx.reshape(-1)])


def synthetic_sbm(n_nodes=400, n_classes=4, feat_dim=32, p_in=0.06,
                  p_out=0.005, seed=0):
    """Stochastic-block-model node-classification dataset (Cora surrogate).
    The JAX package draws one uniform per node pair i < j in a Python
    loop; the same draws come here from one vectorized call, in the same
    order, so the graph is the same."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes)
    i, j = np.triu_indices(n_nodes, 1)
    p = np.where(labels[i] == labels[j], p_in, p_out)
    hit = rng.random(i.shape[0]) < p
    i, j = i[hit], j[hit]
    edge_index = np.stack([np.stack([i, j], 1).reshape(-1),
                           np.stack([j, i], 1).reshape(-1)])
    centers = rng.normal(size=(n_classes, feat_dim))
    x = centers[labels] + 1.5 * rng.normal(size=(n_nodes, feat_dim))
    masks = rng.random(n_nodes)
    return {
        "x": x.astype(np.float32),
        "y": labels.astype(np.int32),
        "edge_index": edge_index,
        "train_mask": masks < 0.4,
        "val_mask": (masks >= 0.4) & (masks < 0.6),
        "test_mask": masks >= 0.6,
    }


def load_planetoid(data_dir, name="cora"):
    """Planetoid file-format loader (ind.<name>.{x,tx,allx,y,ty,ally,graph,
    test.index}) with the standard public splits: train = the labeled
    ``x`` block, val = the next 500 nodes, test = the ``tx`` block at its
    true (permuted, possibly gapped) indices. The synthetic_sbm dict
    schema; FileNotFoundError when the files are absent."""

    def _read(part):
        path = os.path.join(data_dir, f"ind.{name}.{part}")
        with open(path, "rb") as f:
            return pickle.load(f, encoding="latin1")

    x, tx, allx = _read("x"), _read("tx"), _read("allx")
    y, ty, ally = _read("y"), _read("ty"), _read("ally")
    graph = _read("graph")
    idx_path = os.path.join(data_dir, f"ind.{name}.test.index")
    test_idx = np.loadtxt(idx_path, dtype=np.int64).reshape(-1)

    def _dense(m):
        return np.asarray(m.todense() if hasattr(m, "todense") else m,
                          np.float32)

    allx, tx, x = _dense(allx), _dense(tx), _dense(x)
    # citeseer's test.index has gaps: size the graph from the index range
    n = int(max(
        allx.shape[0] + (test_idx.max() - test_idx.min() + 1),
        test_idx.max() + 1,
        allx.shape[0] + tx.shape[0],
    ))
    feats = np.zeros((n, allx.shape[1]), np.float32)
    feats[: allx.shape[0]] = allx
    order = np.sort(test_idx)
    feats[test_idx] = tx
    labels_oh = np.zeros((n, np.asarray(y).shape[1]), np.float32)
    labels_oh[: np.asarray(ally).shape[0]] = np.asarray(ally, np.float32)
    labels_oh[test_idx] = np.asarray(ty, np.float32)
    labels = labels_oh.argmax(axis=1).astype(np.int32)

    src, dst = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            if u == v:
                continue
            src.append(u)
            dst.append(v)
    edge_index = np.stack([np.asarray(src, np.int64),
                           np.asarray(dst, np.int64)])

    n_train = x.shape[0]
    train_mask = np.zeros(n, bool)
    train_mask[:n_train] = True
    val_mask = np.zeros(n, bool)
    val_mask[n_train:n_train + 500] = True
    test_mask = np.zeros(n, bool)
    test_mask[order] = True
    return {
        "x": feats,
        "y": labels,
        "edge_index": edge_index,
        "train_mask": train_mask,
        "val_mask": val_mask,
        "test_mask": test_mask,
    }


def load_heterophilic(data_dir, name="cornell", split=0):
    """Geom-GCN raw-file loader for the heterophilic benchmarks (cornell,
    texas, wisconsin, chameleon, squirrel, film/actor):
    ``out1_node_feature_label.txt`` (dense features, or for film the
    active keyword indices of a 932-dim multi-hot), ``out1_graph_edges.txt``
    (made undirected, self loops dropped, duplicates merged) and
    ``<name>_split_0.6_0.2_<split>.npz``. The synthetic_sbm dict schema;
    FileNotFoundError when absent."""
    base = os.path.join(data_dir, name)
    fl = os.path.join(base, "out1_node_feature_label.txt")
    ge = os.path.join(base, "out1_graph_edges.txt")
    with open(fl) as f:
        lines = [ln.rstrip("\n") for ln in f][1:]
    n = len(lines)
    labels = np.zeros(n, np.int32)
    if name in ("film", "actor"):
        feats = np.zeros((n, 932), np.float32)
        for ln in lines:
            nid, fstr, lab = ln.split("\t")
            feats[int(nid), [int(i) for i in fstr.split(",")]] = 1.0
            labels[int(nid)] = int(lab)
    else:
        rows = [None] * n
        for ln in lines:
            nid, fstr, lab = ln.split("\t")
            rows[int(nid)] = np.asarray(
                [float(v) for v in fstr.split(",")], np.float32)
            labels[int(nid)] = int(lab)
        feats = np.stack(rows)
    with open(ge) as f:
        pairs = np.asarray(
            [[int(a) for a in ln.split()] for ln in f.read().split("\n")[1:]
             if ln.strip()], np.int64).T
    und = np.concatenate([pairs, pairs[::-1]], axis=1)
    und = und[:, und[0] != und[1]]
    und = np.unique(und, axis=1)
    sp = np.load(os.path.join(
        base, f"{name}_split_0.6_0.2_{int(split)}.npz"))
    return {
        "x": feats,
        "y": labels,
        "edge_index": und,
        "train_mask": np.asarray(sp["train_mask"], bool),
        "val_mask": np.asarray(sp["val_mask"], bool),
        "test_mask": np.asarray(sp["test_mask"], bool),
    }


# -- edge-list ops ------------------------------------------------------------


def spmm(graph: Graph, w, x):
    """A @ x with per-edge weights w: the weighted source rows summed into
    their destinations."""
    src, dst = graph.edge_index
    msg = w.to(x.dtype)[:, None] * x.index_select(0, src)
    return x.new_zeros((graph.num_nodes,) + x.shape[1:]).index_add(
        0, dst, msg)


def segment_softmax(scores, segment_ids, num_segments):
    """Softmax of ``scores`` (E,) or (E, heads) over the entries sharing a
    segment id, every head in one pass."""
    shape = (num_segments,) + scores.shape[1:]
    idx = segment_ids.view((-1,) + (1,) * (scores.dim() - 1)).expand_as(
        scores)
    smax = scores.new_full(shape, float("-inf")).scatter_reduce(
        0, idx, scores.detach(), "amax", include_self=False)
    ex = torch.exp(scores - smax.index_select(0, segment_ids))
    norm = scores.new_zeros(shape).index_add(0, segment_ids, ex)
    return ex / norm.index_select(0, segment_ids).clamp_min(1e-16)


def renormalise_attention(w, edge_index, num_nodes, norm_idx=0):
    """Per-incidence renormalization of (possibly zeroed) edge weights."""
    seg = edge_index[norm_idx]
    sums = w.new_zeros(num_nodes).index_add(0, seg, w)
    return w / (sums.index_select(0, seg) + 1e-16)


def hard_attention_weights(mean_att, edge_index, num_nodes, samp_pct,
                           norm_idx=0):
    """The hard-attention block's weights: the head-mean attention above
    its (1 - samp_pct) quantile (linear interpolation, strict >), zero
    elsewhere, renormalized. Dropped edges keep their slot at weight 0."""
    thr = torch.quantile(mean_att, 1.0 - samp_pct)
    w = torch.where(mean_att > thr, mean_att, torch.zeros_like(mean_att))
    return renormalise_attention(w, edge_index, num_nodes, norm_idx)


def rewire_topk_weights(scores, edge_index, num_nodes, n_keep, norm_idx=0):
    """Rewiring as reweighting at static shape: the ``n_keep`` highest
    scores (ties at the k-th kept too) stay, the rest are zeroed, and the
    survivors are renormalized."""
    kth = torch.topk(scores, n_keep).values[-1]
    w = torch.where(scores >= kth, scores, torch.zeros_like(scores))
    return renormalise_attention(w, edge_index, num_nodes, norm_idx)


# -- attention layers and dynamics --------------------------------------------


def _fan_avg_linear(d_in, d_out, bias, distribution):
    """An ``nn.Linear`` drawn as flax's ``Dense`` with a fan-avg kernel
    init (zero bias)."""
    lin = nn.Linear(d_in, d_out, bias=bias)
    fan_avg_(lin.weight, d_in, d_out, distribution)
    if bias:
        with torch.no_grad():
            lin.bias.zero_()
    return lin


def _scalar(value):
    return nn.Parameter(torch.tensor(float(value)))


class TransAttention(nn.Module):
    """Multi-head scaled-dot graph attention over the edge list; returns
    the (E, heads) attention, softmax over the edges sharing their src
    (norm_idx 0) or dst (1)."""

    def __init__(self, hidden_dim: int, heads: int = 4, norm_idx: int = 0):
        super().__init__()
        self.heads, self.norm_idx = heads, norm_idx
        self.dk = max(1, hidden_dim // heads)
        self.Q = _fan_avg_linear(hidden_dim, self.dk * heads, True, "uniform")
        self.K = _fan_avg_linear(hidden_dim, self.dk * heads, True, "uniform")

    def forward(self, x, graph: Graph):
        src, dst = graph.edge_index
        Qh = self.Q(x).view(-1, self.heads, self.dk)
        Kh = self.K(x).view(-1, self.heads, self.dk)
        scores = torch.sum(Qh.index_select(0, src) * Kh.index_select(0, dst),
                           dim=-1) / float(np.sqrt(self.dk))
        return segment_softmax(scores, graph.edge_index[self.norm_idx],
                               graph.num_nodes)


class GATAttention(nn.Module):
    """Sparse GAT attention: h = x W split into heads, per-edge score
    leakyrelu(h_src . a_src + h_dst . a_dst) with a_src, a_dst (dk, 1)
    shared across heads, softmax over edge[norm_idx]. Returns (att (E,
    heads), wx (N, heads dk))."""

    def __init__(self, hidden_dim: int, heads: int = 4,
                 leaky_slope: float = 0.2, norm_idx: int = 0):
        super().__init__()
        self.heads, self.leaky_slope = heads, leaky_slope
        self.norm_idx = norm_idx
        dk = self.dk = max(1, hidden_dim // heads)
        self.W = _fan_avg_linear(hidden_dim, dk * heads, False,
                                 "truncated_normal")
        self.a_src = nn.Parameter(fan_avg_(torch.empty(dk, 1), dk, 1))
        self.a_dst = nn.Parameter(fan_avg_(torch.empty(dk, 1), dk, 1))

    def forward(self, x, graph: Graph):
        wx = self.W(x)
        h = wx.view(-1, self.heads, self.dk)
        src, dst = graph.edge_index
        scores = ((h @ self.a_src[:, 0]).index_select(0, src)
                  + (h @ self.a_dst[:, 0]).index_select(0, dst))
        scores = F.leaky_relu(scores, self.leaky_slope)
        att = segment_softmax(scores, graph.edge_index[self.norm_idx],
                              graph.num_nodes)
        return att, wx


class LaplacianFunc(nn.Module):
    """du/dt = alpha (A u - u) + beta u0 on the fixed adjacency; ``att_w``
    replaces its edge weights (the hard-attention blocks)."""

    def __init__(self, hidden_dim: int, add_source: bool = True,
                 no_alpha_sigmoid: bool = False):
        super().__init__()
        self.add_source, self.no_alpha_sigmoid = add_source, no_alpha_sigmoid
        self.alpha_train = _scalar(1.0)
        self.beta_train = _scalar(1.0)

    def forward(self, t, x, graph: Graph, x0, att_w=None):
        alpha = (self.alpha_train if self.no_alpha_sigmoid
                 else torch.sigmoid(self.alpha_train))
        ax = spmm(graph, graph.edge_weight if att_w is None else att_w, x)
        f = alpha * (ax - x)
        if self.add_source:
            f = f + self.beta_train * x0
        return f


class AttentionFunc(nn.Module):
    """du/dt = alpha (A(u) u - u) + beta u0, the head-mean transformer
    attention recomputed at every evaluation."""

    def __init__(self, hidden_dim: int, heads: int = 4,
                 add_source: bool = True, no_alpha_sigmoid: bool = False):
        super().__init__()
        self.add_source, self.no_alpha_sigmoid = add_source, no_alpha_sigmoid
        self.alpha_train = _scalar(1.0)
        self.beta_train = _scalar(1.0)
        self.attention = TransAttention(hidden_dim, heads)

    def forward(self, t, x, graph: Graph, x0):
        alpha = (self.alpha_train if self.no_alpha_sigmoid
                 else torch.sigmoid(self.alpha_train))
        ax = spmm(graph, torch.mean(self.attention(x, graph), dim=1), x)
        f = alpha * (ax - x)
        if self.add_source:
            f = f + self.beta_train * x0
        return f


class GATFunc(nn.Module):
    """du/dt = alpha (A_GAT(u) u - u) + beta u0: head-averaged GAT
    aggregation of u (mix_features False) or of x W followed by Wout
    (mix_features True)."""

    def __init__(self, hidden_dim: int, heads: int = 4,
                 add_source: bool = True, no_alpha_sigmoid: bool = False,
                 mix_features: bool = False, leaky_slope: float = 0.2):
        super().__init__()
        self.add_source, self.no_alpha_sigmoid = add_source, no_alpha_sigmoid
        self.mix_features = mix_features
        self.alpha_train = _scalar(1.0)
        self.beta_train = _scalar(1.0)
        self.attention = GATAttention(hidden_dim, heads=heads,
                                      leaky_slope=leaky_slope)
        if mix_features:
            self.Wout = _fan_avg_linear(self.attention.dk * heads, hidden_dim,
                                        False, "truncated_normal")

    def forward(self, t, x, graph: Graph, x0):
        alpha = (self.alpha_train if self.no_alpha_sigmoid
                 else torch.sigmoid(self.alpha_train))
        att, wx = self.attention(x, graph)
        # the mean over heads of per-head spmms is one spmm with the
        # head-mean weights (spmm is linear in them)
        ax = spmm(graph, torch.mean(att, dim=1),
                  wx if self.mix_features else x)
        if self.mix_features:
            ax = self.Wout(ax)
        f = alpha * (ax - x)
        if self.add_source:
            f = f + self.beta_train * x0
        return f


class HeavyBallFunc(nn.Module):
    """Heavy-ball dynamics on the (N, 2, H) state (h, m)::

        dh/dt = -m
        dm/dt = net(h) - sigmoid(gamma) m + softplus(corr) h

    net = dense/tanh/dense/tanh/dense, gamma trainable (init -3), corr a
    frozen constant. The graph is not used."""

    def __init__(self, hidden_dim: int, gamma_guess: float = -3.0,
                 corr: float = 0.0):
        super().__init__()
        self.corr = corr
        self._softplus_corr = float(F.softplus(torch.tensor(
            corr, dtype=torch.float64)))
        self.layers = nn.ModuleList(
            [dense(hidden_dim, hidden_dim) for _ in range(3)])
        self.gamma = _scalar(gamma_guess)

    def forward(self, t, x, graph: Graph, x0):
        h, m = x[:, 0], x[:, 1]
        l0, l1, l2 = self.layers
        out = l2(torch.tanh(l1(torch.tanh(l0(h)))))
        dm = out - torch.sigmoid(self.gamma) * m + self._softplus_corr * h
        return torch.stack([-m, dm], dim=1)


class CGNNFunc(nn.Module):
    """Continuous-GNN dynamics on the zero-augmented state:
    dx/dt = sigmoid(alpha)[:, None] 0.5 (A x - x) + x0, alpha per node."""

    def __init__(self, num_nodes: int, alpha_init: float = 1.0):
        super().__init__()
        self.alpha_train = nn.Parameter(torch.full((num_nodes,),
                                                   float(alpha_init)))

    def forward(self, t, x, graph: Graph, x0):
        ax = spmm(graph, graph.edge_weight, x)
        return torch.sigmoid(self.alpha_train)[:, None] * 0.5 * (ax - x) + x0


# -- the model ----------------------------------------------------------------


def dropout(x, p, generator):
    """Inverted dropout with the keep mask drawn from ``generator`` (in
    fp32 on the generator's device, so a seed gives the same mask whatever
    the tensor's dtype); no generator or p 0: x as it is."""
    if generator is None or p <= 0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=generator.device,
                      dtype=torch.float32) < 1.0 - p
    return x * keep.to(device=x.device, dtype=x.dtype) / (1.0 - p)


class GRANDModel(nn.Module):
    """Encoder -> GRAND ODE block -> decoder::

        model = GRANDModel(graph, in_dim, hidden_dim, n_classes,
                           function="laplacian", block="pnode", T=1.0,
                           step_size=0.25, device="cuda")
        logits = model(x, training=True, generator=gen)

    ``function``: laplacian | transformer | gat | hbnode | cgnn; ``block``:
    pnode | imex | hard_att | rewire_att | heavyball. ``block="hard_att"``
    diffuses with the transformer attention of the encoded state, its head
    mean quantile-thresholded at ``att_samp_pct`` in training (optionally
    flux-weighted by ||h_src - h_dst||), renormalized and frozen for the
    solve. ``block="rewire_att"`` fixes a candidate edge set at setup (base
    and two-hop, or base and random extras) and keeps each forward's top
    ``rewire_K`` candidates by frozen attention. ``pos_dim`` > 0 is
    beltrami mode: a second encoder of the positional encodings,
    concatenated into the state.

    The solver's dynamics take one flat parameter dict: the dynamics'
    ``named_parameters()`` plus ``x0`` (the source term) and, for the
    attention blocks, ``att_w``; both are detached inside the dynamics, so
    their adjoint cotangents are 0 and the encoder's gradient comes
    through y0 alone. The IMEX block passes that dict to both parts, whose
    alpha gradients autograd sums. The model lives on ``device`` (its
    graphs included); a CUDA device without CUDA raises.
    """

    def __init__(
        self,
        graph: Graph,
        in_dim: int,
        hidden_dim: int,
        n_classes: int,
        function: str = "laplacian",
        block: str = "pnode",
        T: float = 1.0,
        step_size: float = 0.25,
        method: str = "dopri5",
        heads: int = 4,
        input_dropout: float = 0.5,
        dropout: float = 0.5,
        add_source: bool = True,
        pos_dim: int = 0,
        pos_hidden: int = 16,
        att_samp_pct: float = 1.0,
        use_flux: bool = False,
        attention_norm_idx: int = 0,
        cgnn_alpha: float = 1.0,
        rw_addD: float = 0.2,
        rewire_candidates: str = "two_hop",
        rewire_seed: int = 0,
        device="cuda",
        dtype=None,
    ):
        super().__init__()
        self.hidden = hidden_dim
        self.T = T
        self.block = block
        self.input_dropout = input_dropout
        self.dropout = dropout
        self.pos_dim = int(pos_dim)
        self.pos_hidden = int(pos_hidden) if pos_dim else 0
        if self.pos_dim and self.pos_hidden >= hidden_dim:
            raise ValueError(
                f"pos_hidden ({self.pos_hidden}) must be < hidden_dim "
                f"({hidden_dim}): the feature encoder gets the remainder")
        self.enc = dense(in_dim, hidden_dim - self.pos_hidden)
        self.enc_pos = (dense(self.pos_dim, self.pos_hidden)
                        if self.pos_dim else None)
        self.dec = dense(hidden_dim, n_classes)
        if function == "laplacian":
            self.func = LaplacianFunc(hidden_dim, add_source=add_source)
        elif function == "gat":
            self.func = GATFunc(hidden_dim, heads=heads,
                                add_source=add_source)
        elif function == "transformer":
            self.func = AttentionFunc(hidden_dim, heads=heads,
                                      add_source=add_source)
        elif function == "hbnode":
            if block not in ("pnode", "heavyball"):
                raise ValueError(
                    "function='hbnode' integrates the stacked (h, m) "
                    "state explicitly; use block='pnode'|'heavyball'")
            self.func = HeavyBallFunc(hidden_dim)
        elif function == "cgnn":
            if block != "pnode":
                raise ValueError(
                    "function='cgnn' is an explicit baseline; use "
                    "block='pnode'")
            self.func = CGNNFunc(graph.num_nodes, alpha_init=cgnn_alpha)
        else:
            raise ValueError(
                f"unknown GRAND function {function!r} "
                "(choose laplacian | transformer | gat | hbnode | cgnn)")
        self._heavyball = function == "hbnode"
        self._cgnn = function == "cgnn"
        if block == "heavyball":
            self.block = block = "pnode"  # the same explicit solve
        diffusion_graph = graph
        self.rewire_K = None
        self.hard_att = None
        if block == "hard_att":
            if not 0.0 < att_samp_pct <= 1.0:
                raise ValueError(
                    "attention sampling threshold must be in (0,1]")
            if function != "laplacian":
                raise ValueError(
                    "block='hard_att' diffuses with the sampled attention "
                    "as a FIXED operator (laplacian form); use "
                    "function='laplacian'")
            self.hard_att = TransAttention(hidden_dim, heads=heads,
                                           norm_idx=attention_norm_idx)
        elif block == "rewire_att":
            if function != "laplacian":
                raise ValueError(
                    "block='rewire_att' diffuses with the selected "
                    "attention as a FIXED operator (laplacian form); use "
                    "function='laplacian'")
            if not 0.0 < rw_addD < 1.0:
                raise ValueError("rw_addD must be in (0,1)")
            base_ei = _np(graph.edge_index)
            if rewire_candidates == "two_hop":
                cand = two_hop(base_ei, graph.num_nodes)
            elif rewire_candidates == "random":
                extra = random_extra_edges(graph.num_nodes, rw_addD,
                                           seed=rewire_seed)
                cand = np.unique(np.concatenate([base_ei, extra], axis=1),
                                 axis=1)
            else:
                raise ValueError(
                    f"unknown rewire_candidates {rewire_candidates!r} "
                    "(two_hop | random)")
            diffusion_graph = _graph(cand, np.ones(cand.shape[1]),
                                     graph.num_nodes)
            # keep ~(1 + rw_addD) x the base edge count
            self.rewire_K = min(cand.shape[1], int(round(
                base_ei.shape[1] * (1.0 + rw_addD))))
            self.hard_att = TransAttention(hidden_dim, heads=heads,
                                           norm_idx=attention_norm_idx)
        self.att_samp_pct = float(att_samp_pct)
        self.use_flux = bool(use_flux)
        self.attention_norm_idx = int(attention_norm_idx)
        self.method = method
        self.step_size = step_size
        self._solvers = {}
        on_device(self, device, dtype)
        self.device = torch.device(device)
        self.graph = graph.to(self.device)
        self.diffusion_graph = (self.graph if diffusion_graph is graph
                                else diffusion_graph.to(self.device))

    def _augment(self, h0):
        """(solver state y0, dynamics source x0): heavy-ball stacks a zero
        momentum on axis 1; CGNN concatenates zero channels and sources
        the augmented state."""
        if self._heavyball:
            return torch.stack([h0, torch.zeros_like(h0)], dim=1), h0
        if self._cgnn:
            y0 = torch.cat([h0, torch.zeros_like(h0)], dim=-1)
            return y0, y0
        return h0, h0

    def _readout(self, h_final):
        """Decoder input from the final state (a leading time axis too)."""
        if self._heavyball:
            return h_final[..., 0, :]
        if self._cgnn:
            return F.relu(h_final[..., : self.hidden])
        return h_final

    def rewire(self, new_graph: Graph):
        """Swap the base graph (periodic kNN rewiring) and drop the cached
        solvers."""
        if self.block == "rewire_att":
            raise ValueError(
                "rewire() swaps the base graph; block='rewire_att' already "
                "reselects edges every forward from its candidate set")
        self.graph = self.diffusion_graph = new_graph.to(self.device)
        self._solvers.clear()

    def _hard_att_weights(self, h0, training):
        """Per-edge diffusion weights of the attention blocks, computed
        without a graph (frozen for the solve): hard_att thresholds in
        training only; rewire_att selects its top-K in both modes."""
        g = self.diffusion_graph
        with torch.no_grad():
            mean_att = torch.mean(self.hard_att(h0, g), dim=1)
            if self.block == "rewire_att" or training:
                if self.use_flux:
                    src, dst = g.edge_index
                    mean_att = mean_att * torch.linalg.vector_norm(
                        h0.index_select(0, src) - h0.index_select(0, dst),
                        dim=1)
                if self.block == "rewire_att":
                    mean_att = rewire_topk_weights(
                        mean_att, g.edge_index, g.num_nodes, self.rewire_K,
                        self.attention_norm_idx)
                else:
                    mean_att = hard_attention_weights(
                        mean_att, g.edge_index, g.num_nodes,
                        self.att_samp_pct, self.attention_norm_idx)
        return mean_att

    def _encode(self, x, pos_encoding):
        h = self.enc(x)
        if self.pos_dim:
            if pos_encoding is None:
                raise ValueError("beltrami mode needs pos_encoding")
            p = self.enc_pos(pos_encoding.to(h.dtype))
            h = torch.cat([h, p], dim=-1)
        return h

    def forward_encoder(self, x, pos_encoding=None):
        """Encoded node features (the kNN rewiring's T0 mode)."""
        return self._encode(x, pos_encoding)

    def _dynamics(self):
        """f(t, y, p) of the solver: the dynamics module evaluated on the
        dynamics' entries of the flat dict p, x0 and att_w detached."""
        func = self.func

        def f(t, y, p):
            fp = {k: v for k, v in p.items() if k not in ("x0", "att_w")}
            kw = {} if "att_w" not in p else {"att_w": p["att_w"].detach()}
            return torch.func.functional_call(
                func, fp, (t, y, self.diffusion_graph, p["x0"].detach()), kw)

        return f

    def _get_solver(self, shape, dtype, training):
        key = (shape, dtype, training)
        ode = self._solvers.get(key)
        if ode is None:
            ode = ODESolver()
            tmpl = torch.zeros(shape, dtype=dtype, device=self.device)
            f = self._dynamics()
            if self.block == "imex":
                # implicit: -sigmoid(alpha) y (identity diffusion);
                # explicit: the full f + sigmoid(alpha) y
                def f_im(t, y, p):
                    return -torch.sigmoid(p["alpha_train"]) * y

                def f_ex(t, y, p):
                    return f(t, y, p) + torch.sigmoid(p["alpha_train"]) * y

                ode.setupTS(tmpl, (f_im, {}), func2=(f_ex, {}),
                            step_size=self.step_size, method="imex",
                            imex_form=True, implicit_form=True,
                            enable_adjoint=training)
            else:
                ode.setupTS(tmpl, (f, {}), step_size=self.step_size,
                            method=self.method, enable_adjoint=training)
            self._solvers[key] = ode
        return ode

    def _solve(self, h0, times, training):
        """The block's solve from the encoded state h0: (outputs, stats)."""
        y0, x0 = self._augment(h0)
        ode = self._get_solver(tuple(y0.shape), y0.dtype, training)
        p = dict(self.func.named_parameters())
        p["x0"] = x0
        if self.hard_att is not None:
            p["att_w"] = self._hard_att_weights(h0, training)
        if self.block == "imex":
            p = (p, p)
        return ode.solve(y0, times, params=p, with_adjoint=training)

    def forward_ode(self, x, pos_encoding=None):
        """Post-diffusion node state, pre-decoder (the kNN rewiring's TN
        mode)."""
        sol, _ = self._solve(self._encode(x, pos_encoding),
                             np.array([0.0, self.T]), False)
        return self._readout(sol[-1])

    def apply_multi(self, x, times, pos_encoding=None):
        """Decoded logits at several times (n_t, N, C), one solve over
        ``times`` (its first entry is the start time, as in the JAX
        package): the early-stop evaluation mode."""
        sol, _ = self._solve(self._encode(x, pos_encoding),
                             np.asarray(times, dtype=np.float64), False)
        return self.dec(self._readout(sol))

    def forward(self, x, training: bool = True,
                generator: Optional[torch.Generator] = None,
                pos_encoding=None):
        """Logits (N, C). ``training`` solves with the discrete adjoint
        (and selects the training attention weights); dropout draws from
        ``generator`` where one is given, none without."""
        if training:
            x = dropout(x, self.input_dropout, generator)
        sol, _ = self._solve(self._encode(x, pos_encoding),
                             np.array([0.0, self.T]), training)
        h = self._readout(sol[-1])
        if training:
            h = dropout(h, self.dropout, generator)
        return self.dec(h)
