"""The ReLU decisions a K5 check hands to the plain version.

Where a hidden unit's preactivation lies within fp32 rounding of 0, two
correct fp32 evaluations send it either way, and the flip moves a layer's
gradient by ~1e-3 norm-wise. chip_smoke.py's K5 check then holds the
kernel against the plain version in fp64 with the kernel's own decisions:
``reverse_relu_masks`` (ops/fused_ark_adjoint.py) recomputes them from the
stage values the kernel stored, in the order csrc/ark_tiles.cuh's
``rev_forward`` sums, and the plain versions take them (``masks``,
``relu_masks``). Here: that order (split k, group order, one FMA per
product), agreement with fp64 away from 0, that the hooks change nothing
when handed the plain version's own decisions and change the gradient when
handed others, and K5's workspace argument.
"""

import numpy as np
import pytest
import torch

from pnode_tpu_torch.ops import fused_adaptive_loop as fal
from pnode_tpu_torch.ops.fused_ark_adjoint import (
    _split_k, fused_ark_step_adj_plain, reverse_relu_masks,
)
from pnode_tpu_torch.ops.fused_mlp import fused_mlp_bwd_plain
from pnode_tpu_torch.tableaus import get_ark_tableau

torch.set_num_threads(1)


def _stack(dims, seed, scale=None):
    rng = np.random.default_rng(seed)
    Ws = [torch.tensor(rng.normal(0, scale or a ** -0.5, (a, b)),
                       dtype=torch.float32) for a, b in zip(dims, dims[1:])]
    bs = [torch.tensor(rng.normal(0, 0.1, b), dtype=torch.float32)
          for b in dims[1:]]
    return rng, Ws, bs


def _own_masks(x, Ws, bs):
    """The plain fp32 version's own decisions z > 0."""
    out, h = [], x
    for W, b in zip(Ws[:-1], bs[:-1]):
        z = h @ W + b
        out.append(z > 0)
        h = torch.relu(z)
    return out


def test_masks_split_k_and_sum_the_groups_in_order():
    """K 8, N 4: two groups (k even, k odd). Group 0 sums 1e8 - 1e8 = 0,
    group 1 sums 1, so z = 1 - 0.5 > 0; summed in k order, 1e8 + 1 rounds
    to 1e8 in fp32 and z would be -0.5."""
    assert _split_k(8, 4) == 2
    h = torch.zeros(1, 8)
    h[0, :3] = 1.0
    W = torch.zeros(8, 4)
    W[:3, 0] = torch.tensor([1e8, 1.0, -1e8])
    b = torch.tensor([-0.5, 0.0, 0.0, 0.0])
    mask, = reverse_relu_masks(h, [W, torch.zeros(4, 8)],
                               [b, torch.zeros(8)])
    assert mask.tolist() == [[True, False, False, False]]


def test_masks_fuse_each_product_into_its_sum():
    """K 2, one group: fma(1 + 2^-12, 1 + 2^-12, -(1 + 2^-11)) = 2^-24,
    where a rounded product (1 + 2^-11, the tie to even) would leave 0."""
    assert _split_k(2, 1) == 1
    e = 2.0 ** -12
    h = torch.tensor([[1.0, 1.0 + e]])
    W = torch.tensor([[-(1.0 + 2 * e)], [1.0 + e]])
    mask, = reverse_relu_masks(h, [W, torch.ones(1, 2)],
                               [torch.zeros(1), torch.zeros(2)])
    assert mask.tolist() == [[True]]


@pytest.mark.parametrize("dims", [[64, 104, 104, 64], [16, 13, 13, 16],
                                  [64, 24, 24, 24, 64]])
def test_masks_agree_with_fp64_away_from_zero(dims):
    """Every decision equals fp64's on the same fp32 inputs wherever |z| /
    (|h| |W| + |b|) > 1e-5 (fp32 rounding reaches ~1e-6 there); leading
    axes (trial, stage, row) are kept."""
    rng, Ws, bs = _stack(dims, 0)
    ys = torch.tensor(rng.normal(size=(3, 2, 7, dims[0])),
                      dtype=torch.float32)
    masks = reverse_relu_masks(ys, Ws, bs)
    h = ys.reshape(-1, dims[0]).double()
    for l, m in enumerate(masks):
        assert m.shape == (3, 2, 7, dims[l + 1]) and m.dtype == torch.bool
        W, b = Ws[l].double(), bs[l].double()
        z = h @ W + b
        far = z.abs() / (h.abs() @ W.abs() + b.abs()) > 1e-5
        assert torch.equal(m.reshape(z.shape)[far], (z > 0)[far])
        h = torch.where(m.reshape(z.shape), z, torch.zeros_like(z))


def test_mlp_backward_with_its_own_decisions_is_unchanged():
    rng, Ws, bs = _stack([16, 24, 24, 16], 1)
    x = torch.tensor(rng.normal(size=(9, 16)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(9, 16)), dtype=torch.float32)
    a = fused_mlp_bwd_plain(x, g, Ws, bs)
    b = fused_mlp_bwd_plain(x, g, Ws, bs, masks=_own_masks(x, Ws, bs))
    for p, q in zip([a[0], *a[1], *a[2]], [b[0], *b[1], *b[2]]):
        assert torch.equal(p, q)


def test_mlp_backward_takes_the_decisions_it_is_given():
    """One unit of one row flipped on: h there is z (negative), and the
    backprop passes that unit's covector; only that row and unit move."""
    rng, Ws, bs = _stack([16, 24, 24, 16], 2)
    x = torch.tensor(rng.normal(size=(9, 16)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(9, 16)), dtype=torch.float32)
    own = _own_masks(x, Ws, bs)
    r, u = [(r, u) for r in range(9) for u in range(24)
            if not own[0][r, u]][0]
    flipped = [own[0].clone(), own[1]]
    flipped[0][r, u] = True
    a = fused_mlp_bwd_plain(x, g, Ws, bs, masks=own)
    b = fused_mlp_bwd_plain(x, g, Ws, bs, masks=flipped)
    assert not torch.equal(a[1][0][:, u], b[1][0][:, u])  # dW0's column u
    assert torch.equal(a[1][0][:, :u], b[1][0][:, :u])
    assert not torch.equal(a[0][r], b[0][r])  # dx of row r
    others = [i for i in range(9) if i != r]
    assert torch.equal(a[0][others], b[0][others])


def test_masks_need_relu():
    _, Ws, bs = _stack([4, 6, 4], 3)
    x = torch.ones(2, 4)
    with pytest.raises(ValueError, match="relu"):
        fused_mlp_bwd_plain(x, x, Ws, bs, "tanh", masks=_own_masks(x, Ws,
                                                                   bs))


def _tab(with_err=False):
    t = get_ark_tableau("3")
    tab = ([[float(x) for x in r] for r in t.a_im],
           [[float(x) for x in r] for r in t.a_ex],
           [float(x) for x in t.b_im], [float(x) for x in t.b_ex])
    if with_err:
        tab += ([float(x) for x in t.b_im_err], [float(x) for x in t.b_ex_err])
    return tab, t


def test_reverse_step_passes_each_stage_its_decisions():
    """fused_ark_step_adj_plain hands stage i masks[i] to the MLP backward:
    its own decisions change nothing; stage 3's all off drops that
    stage's MLP term."""
    tab, _ = _tab()
    d = 8
    rng, Ws, bs = _stack([d, 12, 12, d], 4)
    f = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32)  # noqa: E731
    Ys, lam, J, inv = f(4, 5, d), f(5, d), f(d, d) * 0.1, f(d, d) * 0.1
    own = [_own_masks(Ys[i], Ws, bs) for i in range(4)]
    a = fused_ark_step_adj_plain(tab, 0.05, Ys, lam, J, inv, Ws, bs)
    b = fused_ark_step_adj_plain(tab, 0.05, Ys, lam, J, inv, Ws, bs,
                                 masks=own)
    flat = lambda o: [o[0], *o[1][0], *o[1][1]]  # noqa: E731
    assert all(torch.equal(p, q) for p, q in zip(flat(a), flat(b)))
    off = own[:3] + [[torch.zeros_like(m) for m in own[3]]]
    c = fused_ark_step_adj_plain(tab, 0.05, Ys, lam, J, inv, Ws, bs,
                                 masks=off)
    assert not torch.equal(a[1][0][0], c[1][0][0])


def _adaptive_case(K=2, B=6, d=8, hidden=(12, 12)):
    tab, t = _tab(True)
    rng, Ws, bs = _stack([d, *hidden, d], 5, scale=0.3)
    Q = torch.tensor(np.linalg.qr(rng.normal(size=(d, d)))[0],
                     dtype=torch.float32)
    lam = -torch.tensor(rng.uniform(1, 30, d), dtype=torch.float32)
    J = (Q * lam) @ Q.T
    y = torch.tensor(rng.normal(size=(K, B, d)), dtype=torch.float32)
    tgt = y + 0.1
    z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b) for b in bs])
    return (tab, float(t.a_im[1][1]), lam, Q, J, 0.2, 0.05, y, tgt, Ws, bs,
            z, z, 0, 32), t.order


def test_adaptive_plain_asks_each_accepted_trial_for_its_decisions():
    """relu_masks(k, n) is asked once per accepted trial of iteration k,
    last to first, n counting every trial; answering None leaves the run
    bitwise as it was; all units off for the last trial's stages moves
    the update."""
    args, order = _adaptive_case()
    plain = fal.fused_adaptive_train_loop_plain
    base = plain(*args, order=order, lr=5e-3)
    asked = []

    def record(k, n):
        asked.append((k, n))
        return None

    same = plain(*args, order=order, lr=5e-3, relu_masks=record)
    st = base[5]
    for k in range(2):
        acc, rej = int(st["accepted"][k]), int(st["rejected"][k])
        got = [n for kk, n in asked if kk == k]
        assert len(got) == acc and got == sorted(got, reverse=True)
        assert all(0 <= n < acc + rej for n in got)
    flat = lambda o: o[0] + o[1] + o[2][0] + o[3][0]  # noqa: E731
    assert all(torch.equal(p, q) for p, q in zip(flat(base), flat(same)))
    last = {k: max(n for kk, n in asked if kk == k) for k in range(2)}
    B, hidden = args[7].shape[1], [12, 12]

    def off(k, n):
        if n != last[k]:
            return None
        return [[torch.zeros(B, w, dtype=torch.bool) for w in hidden]
                for _ in range(4)]

    moved = plain(*args, order=order, lr=5e-3, relu_masks=off)
    assert not torch.equal(base[0][0], moved[0][0])


def test_k5_wrapper_refuses_a_workspace_on_the_cpu():
    args, order = _adaptive_case()
    with pytest.raises(ValueError, match="workspace"):
        fal.fused_adaptive_train_loop(*args, order=order,
                                      workspace=torch.empty(4))
