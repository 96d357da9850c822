"""K6-K9: the fused SqueezeNext ODE dynamics and their backward.

Replaces ``pnode_tpu/ops/fused_sqnxt.py``: ``_fwd_kernel`` (:192, K6),
``_bwd_kernel`` (:206, K7), ``_fwd_layer_kernel`` (:508, K8) and
``_bwd_layer_kernel`` (:522, K9). The CUDA sources are ``csrc/sqnxt_fwd.cu``
(K6, K8) and ``csrc/fused_sqnxt.cu`` (K7, K9), both on the tile functions
of ``csrc/sqnxt_tiles.cuh``, whose note says what bounds the kernels on the
H100 and what the design does about that.

One evaluation of ``ODEDynamics(dim)`` (``models/sqnxt.py``) is a chain of
five layers, each conv -> +b -> batch-stats norm -> ReLU, on a (C, N) state
with N = B*H*W ordered b-major, then i, then j (``to_cn``). The conv taps are
1x1, 1x1, (1,3) (column shifts -1, 0, +1), (3,1) (shifts -W, 0, +W) and 1x1,
each shifted read masked at the image border. The TPU's 128-lane padding of
N is a tiling artifact the port drops: its meta has no ``n_pad``.

- ``fused_sqnxt_dyn(x_cn, params, meta)`` is differentiable: one
  ``torch.autograd.Function`` for the chain (forward K6, backward K7) and one
  for the layered mode (K8 per layer forward, K9 per layer in reverse), the
  counterparts of the JAX package's ``jax.custom_vjp``s.
- ``fused_sqnxt_fwd`` / ``fused_sqnxt_bwd`` / ``fused_sqnxt_layer_fwd`` /
  ``fused_sqnxt_layer_bwd`` launch their kernel for CUDA tensors and run the
  plain PyTorch version for CPU tensors (any float dtype). On the card each
  kernel has two instances: fp32, and bf16 storage (x, g, the taps and b in
  bf16, gamma and beta in fp32, as ``pack_params`` packs them; the
  ``_bf16`` C entry points). Each wrapper counts the launches of its fp32
  instance in ``.launches`` and of its bf16 one in ``.launches_bf16``. Each
  launch takes its grid and the size of its one scratch allocation from the
  C side's plan (``fwd_plan``, ``bwd_plan``: cached per shape, dtype and
  device), checked against the Python mirrors ``fwd_scratch_floats`` and
  ``bwd_scratch_floats``. The scratch is counted in floats in both dtypes:
  its anchors and g buffers take ``ceil(elements * esize / 4)`` floats.
- The plain versions repeat the JAX kernels' dtype round-trips: products of
  the input-dtype operands accumulated in ``work`` (float32, the Pallas
  kernels' ``preferred_element_type``; a bf16 product is exact there), the
  conv output rounded to the input dtype before the bias add, statistics
  and the norm's backward in ``work``, the norm's output rounded to the
  input dtype before the ReLU, g_z rounded to it, each dW rounded through
  it, the cotangents carried in it between layers. In fp32 these are
  identities; ``work=torch.float64`` gives a true fp64 reference.
- ``gate_meta``: the Hopper gate that replaces the TPU's VMEM estimates. The
  chain's backward (K7) keeps its five anchors in one device workspace; the
  chain runs when they fit ``CHAIN_WORKSPACE_BYTES`` (32 MB, inside the 50 MB L2),
  else the layered mode. At B 128 of the full-width model, in fp32: layered
  at stage 1 (46 MB), chain at stages 2 (23 MB) and 3 (11.5 MB); in bf16 the
  anchors take half (the JAX package's ``esize = 2``), so stage 1 (23 MB)
  runs the chain too.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from . import _build

EPS = 1e-5
SINGLE_PASS_MIN = 1 << 20       # BatchStatsNorm.single_pass_min_size
# csrc/sqnxt_tiles.cuh: kMaxC, kTileOut, kMinTiles, kMaxSub, kStoreFloats
MAX_CHANNELS = 128              # channels of a layer
TILE_OUT = 4096                 # outputs of one product tile
MIN_TILES = 256                 # a pass's tiles, halved (split) below it
MAX_DW_TILES = 3                # dW register tiles a thread may hold
STORE_FLOATS = 32768            # K6/K8's store of z tiles in shared memory
TC_MIN_COLUMNS = 32             # kTcMinTN: the tensor-core path's least tile
TC_MAX_BWD_COLUMNS = 256        # kTcMaxTNb: its largest backward tile
CHAIN_WORKSPACE_BYTES = 32 << 20
# the products' rounding and the statistics' dtype of the plain versions: the
# Pallas kernels' fp32 (a test of true fp64 sets it to float64)
WORK = torch.float32
_AXIS_CODES = {None: 0, "j": 1, "i": 2}
_PARTIAL_FLOATS = 2 * 4 * MAX_CHANNELS  # two slots of kMaxQ x kMaxC per block


class SqnxtMeta(NamedTuple):
    """Static description of the 5-layer chain (the JAX package's fields).

    taps[l]: column shifts of layer l's conv taps (shift s reads h[:, n+s]);
    axis[l]: "j" | "i" | None, the image axis the taps move along; cdims:
    (C0, ..., C5); single_pass[l]: BatchStatsNorm's size-gate verdict for
    layer l's output; ``layered``: one kernel per layer instead of the chain.
    """

    taps: Tuple[Tuple[int, ...], ...]
    axis: Tuple[object, ...]
    cdims: Tuple[int, ...]
    single_pass: Tuple[bool, ...]
    H: int
    W: int
    n_real: int
    layered: bool = False


def make_meta(dim: int, B: int, H: int, W: int,
              layered: bool = False) -> SqnxtMeta:
    """Chain spec for ODEDynamics(dim): 1x1 D->c1, 1x1 c1->c2, (1,3) c2->c1,
    (3,1) c1->c1, 1x1 c1->D."""
    c1, c2 = int(dim * 0.5), int(dim * 0.25)
    cdims = (dim, c1, c2, c1, c1, dim)
    taps = ((0,), (0,), (-1, 0, 1), (-W, 0, W), (0,))
    axis = (None, None, "j", "i", None)
    n_real = B * H * W
    single = tuple(n_real * c >= SINGLE_PASS_MIN for c in cdims[1:])
    return SqnxtMeta(taps, axis, cdims, single, H, W, n_real, bool(layered))


def esize_of(dtype) -> int:
    """Bytes of the kernels' storage type for activations of ``dtype``: 2
    for bf16, else 4 (fp32; the CPU's fp64 runs follow the fp32 gate)."""
    return 2 if dtype == torch.bfloat16 else 4


def chain_workspace_bytes(meta: SqnxtMeta, esize: int = 4) -> int:
    """The chain kernels' anchors z_1..z_5, ``esize`` bytes each."""
    return esize * meta.n_real * sum(meta.cdims[1:])


def gate_meta(dim: int, B: int, H: int, W: int,
              dtype=torch.float32) -> SqnxtMeta:
    """The meta the model runs at activations of ``dtype``: chain when its
    workspace fits CHAIN_WORKSPACE_BYTES, else layered. Never "no kernel":
    every shape runs one of the two modes."""
    meta = make_meta(dim, B, H, W)
    return meta._replace(layered=chain_workspace_bytes(
        meta, esize_of(dtype)) > CHAIN_WORKSPACE_BYTES)


def pack_params(params, meta: SqnxtMeta, dtype):
    """ODEDynamics parameter dict -> flat kernel arguments, per layer
    [W (taps, Cout, Cin) dtype, b (Cout,) dtype, gamma (Cout,) fp32,
    beta (Cout,) fp32] (the JAX package's dtypes). Differentiable: the
    gradients flow back to the dict through these reshapes."""
    flat = []
    for li in range(5):
        w = params[f"convs.{li}.weight"]  # (Cout, Cin, kh, kw)
        cout, cin = int(w.shape[0]), int(w.shape[1])
        flat.append(w.permute(2, 3, 0, 1).reshape(-1, cout, cin)
                    .to(dtype).contiguous())
        flat.append(params[f"convs.{li}.bias"].to(dtype).contiguous())
        flat.append(params[f"norms.{li}.scale"].to(WORK).contiguous())
        flat.append(params[f"norms.{li}.bias"].to(WORK).contiguous())
    return tuple(flat)


def to_cn(x: torch.Tensor, meta: SqnxtMeta) -> torch.Tensor:
    """(B, H, W, C) -> (C, N)."""
    n, c = x.shape[0] * x.shape[1] * x.shape[2], x.shape[3]
    return x.reshape(n, c).t().contiguous()


def from_cn(h: torch.Tensor, B: int, H: int, W: int) -> torch.Tensor:
    """(C, N) -> (B, H, W, C)."""
    return h[:, : B * H * W].t().reshape(B, H, W, h.shape[0])


def fused_sqnxt_dyn(x_cn: torch.Tensor, params, meta: SqnxtMeta):
    """The ODEDynamics chain on a (dim, N) state: one K6 launch (layered:
    five K8 launches). Differentiable with respect to both arguments."""
    flat = pack_params(params, meta, x_cn.dtype)
    fn = _LayeredFn if meta.layered else _ChainFn
    return fn.apply(meta, x_cn, *flat)


# -- plain PyTorch versions --------------------------------------------------

def _layer(flat, li):
    return tuple(flat[4 * li: 4 * li + 4])


def _tap_masks(meta: SqnxtMeta, device):
    """(N,) validity masks per (axis, +-1): source j+-1 in [0, W) or i+-1 in
    [0, H)."""
    n = torch.arange(meta.n_real, device=device)
    jm, im = n % meta.W, (n // meta.W) % meta.H
    masks = {}
    for ax, s in (("j", -1), ("j", 1), ("i", -1), ("i", 1)):
        coord, lim = (jm, meta.W) if ax == "j" else (im, meta.H)
        masks[(ax, s)] = (coord + s >= 0) & (coord + s < lim)
    return masks


def _shift(h, s):
    """out[:, n] = h[:, n + s], zero-filled at the ends."""
    if s == 0:
        return h
    z = h.new_zeros(h.shape[0], abs(s))
    if s > 0:
        return torch.cat([h[:, s:], z], dim=1)
    return torch.cat([z, h[:, :s]], dim=1)


def _tap_input(h, s, mask):
    hk = _shift(h, s)
    return hk if s == 0 else hk * mask.to(hk.dtype)


def _conv(h, w, meta, li, masks, work):
    pd = torch.promote_types(h.dtype, work)  # the products' accumulation
    z = None
    for t, s in enumerate(meta.taps[li]):
        mask = None if s == 0 else masks[(meta.axis[li], 1 if s > 0 else -1)]
        d = (w[t].to(pd) @ _tap_input(h, s, mask).to(pd)).to(work)
        z = d if z is None else z + d
    return z


def _layer_fwd(h, lf, meta, li, masks, work):
    """(h_next, zf, m, sr) of one layer in the JAX kernel's order."""
    work = WORK if work is None else work
    w, b = lf[:2]
    dt = h.dtype
    z = _conv(h, w, meta, li, masks, work).to(dt) + b.to(dt)[:, None]
    return norm_relu(z, lf, meta, li, work)


def norm_relu(z, lf, meta, li, work=None):
    """(h_next, zf, m, sr) from layer li's anchor z = conv + b (in the
    activation dtype): the batch-stats norm in ``work`` and the ReLU of its
    output rounded to z's dtype."""
    work = WORK if work is None else work
    gam, bet = lf[2:]
    dt = z.dtype
    zf = z.to(work)
    inv_n = 1.0 / meta.n_real
    m = zf.sum(dim=1, keepdim=True) * inv_n
    if meta.single_pass[li]:
        m2 = (zf * zf).sum(dim=1, keepdim=True) * inv_n
        var = torch.clamp_min(m2 - m * m, 0.0)
    else:
        zc = zf - m
        var = (zc * zc).sum(dim=1, keepdim=True) * inv_n
    sr = torch.sqrt(var + EPS)
    a = (zf - m) / sr * gam.to(work)[:, None] + bet.to(work)[:, None]
    return torch.relu(a.to(dt)), zf, m, sr


def _layer_bwd(h, g, lf, meta, li, masks, work, z=None):
    """(dh, (dW, db, dgam, dbet)) of one layer: recompute z from h (or take
    the anchor ``z``, conv + b in h's dtype), then the stage-exact backprop
    of ``_bwd_layer_kernel``."""
    work = WORK if work is None else work
    w, b, gam, bet = lf
    dt = h.dtype
    _, zf, m, sr = (_layer_fwd(h, lf, meta, li, masks, work) if z is None
                    else norm_relu(z, lf, meta, li, work))
    gam, bet = gam.to(work)[:, None], bet.to(work)[:, None]
    zh = (zf - m) / sr
    a_d = (zh * gam + bet).to(dt)
    g_a = torch.where(a_d.to(work) > 0, g, torch.zeros_like(g)).to(work)
    d_gam = (g_a * zh).sum(dim=1)
    d_bet = g_a.sum(dim=1)
    g_zh = g_a * gam
    inv_n = 1.0 / meta.n_real
    c1 = g_zh.sum(dim=1, keepdim=True) * inv_n
    c2 = (g_zh * zh).sum(dim=1, keepdim=True) * inv_n
    g_zd = ((g_zh - c1 - zh * c2) / sr).to(dt)
    d_b = g_zd.to(work).sum(dim=1)
    pd = torch.promote_types(dt, work)  # the products' accumulation
    g_h, d_ws = None, []
    for t, s in enumerate(meta.taps[li]):
        mask = None if s == 0 else masks[(meta.axis[li], 1 if s > 0 else -1)]
        hk = _tap_input(h, s, mask)
        d_ws.append((g_zd.to(pd) @ hk.to(pd).t()).to(work).to(dt).to(work))
        gk = (w[t].to(pd).t() @ g_zd.to(pd)).to(work)
        if s != 0:
            gk = _shift(gk * mask.to(gk.dtype), -s)
        g_h = gk if g_h is None else g_h + gk
    return g_h.to(dt), (torch.stack(d_ws), d_b, d_gam, d_bet)


def fused_sqnxt_plain(x, flat, meta, work=None):
    """Plain version of K6 (and of K8 applied layer by layer)."""
    masks = _tap_masks(meta, x.device)
    h = x
    for li in range(5):
        h = _layer_fwd(h, _layer(flat, li), meta, li, masks, work)[0]
    return h


def fused_sqnxt_bwd_plain(x, g, flat, meta, work=None):
    """Plain version of K7: (dx, dflat), dflat in ``work``."""
    masks = _tap_masks(meta, x.device)
    hs, h = [], x
    for li in range(5):
        hs.append(h)
        h = _layer_fwd(h, _layer(flat, li), meta, li, masks, work)[0]
    dflat = [None] * len(flat)
    for li in range(4, -1, -1):
        g, d = _layer_bwd(hs[li], g, _layer(flat, li), meta, li, masks, work)
        dflat[4 * li: 4 * li + 4] = d
    return g, tuple(dflat)


def fused_sqnxt_layer_plain(h, layer_flat, meta, li, work=None):
    """Plain version of K8."""
    masks = _tap_masks(meta, h.device)
    return _layer_fwd(h, layer_flat, meta, li, masks, work)[0]


def fused_sqnxt_layer_bwd_plain(h, g, layer_flat, meta, li, work=None):
    """Plain version of K9: (dh, (dW, db, dgam, dbet))."""
    masks = _tap_masks(meta, h.device)
    return _layer_bwd(h, g, layer_flat, meta, li, masks, work)


# -- kernel wrappers ----------------------------------------------------------

def _check(what, x, flats, meta, lis, g=None):
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"{what}: x must be a (C, N) tensor")
    cin = meta.cdims[lis[0]]
    if tuple(x.shape) != (cin, meta.n_real):
        raise ValueError(f"{what}: x must be {(cin, meta.n_real)}, got "
                         f"{tuple(x.shape)}")
    if g is not None and tuple(g.shape) != (meta.cdims[lis[-1] + 1],
                                            meta.n_real):
        raise ValueError(f"{what}: g has shape {tuple(g.shape)}")
    cuda = x.device.type == "cuda"
    if not cuda and x.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {x.device}")
    # on the card: x, g, the taps and b in one storage type (fp32 or bf16),
    # gamma and beta in fp32, all contiguous
    dt = x.dtype
    if cuda and dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: CUDA x must be float32 or bfloat16, got "
                         f"{dt}")
    for li, lf in zip(lis, flats):
        cout, cin, ntap = meta.cdims[li + 1], meta.cdims[li], len(meta.taps[li])
        want = [(ntap, cout, cin), (cout,), (cout,), (cout,)]
        for k, (t, shape) in enumerate(zip(lf, want)):
            if tuple(t.shape) != shape or t.device != x.device:
                raise ValueError(f"{what}: layer {li} argument {tuple(t.shape)}"
                                 f" on {t.device}, expected {shape} on "
                                 f"{x.device}")
            need = dt if k < 2 else torch.float32
            if cuda and (t.dtype != need or not t.is_contiguous()):
                raise ValueError(f"{what}: CUDA arguments must be contiguous, "
                                 f"layer {li} argument {k} {need} (got "
                                 f"{t.dtype})")
    if cuda:
        if max(meta.cdims) > MAX_CHANNELS:
            raise ValueError(f"{what}: the kernels take at most "
                             f"{MAX_CHANNELS} channels, got {meta.cdims}")
        for t in (x, g):
            if t is not None and (t.dtype != dt or not t.is_contiguous()):
                raise ValueError(f"{what}: CUDA x and g must be contiguous "
                                 f"{dt}")
    return cuda


def _row_tile(c: int) -> int:
    return next(t for t in (8, 16, 32, 64, 128) if c <= t)


def _layer_ints(meta, lis):
    ints = []
    for li in lis:
        ints += [meta.cdims[li], meta.cdims[li + 1], len(meta.taps[li]),
                 _AXIS_CODES[meta.axis[li]], int(meta.single_pass[li])]
    return ints


def _chain_layers(meta: SqnxtMeta, lis: Sequence[int], grid: int):
    """``lis`` as a list, after the refusals every SqueezeNext kernel makes:
    1 or 5 layers, a grid >= 1, 1 to 128 channels, taps that match their
    axis, layers that chain."""
    lis = list(lis)
    if len(lis) not in (1, 5) or grid < 1:
        raise ValueError(f"the SqueezeNext kernels take 1 or 5 layers and a "
                         f"grid >= 1, got {len(lis)} and {grid}")
    for k, li in enumerate(lis):
        cin, cout = meta.cdims[li], meta.cdims[li + 1]
        taps = len(meta.taps[li])
        if not (1 <= cin <= MAX_CHANNELS and 1 <= cout <= MAX_CHANNELS):
            raise ValueError(f"the kernels take 1 to {MAX_CHANNELS} channels,"
                             f" got layer {li}: {cin} -> {cout}")
        if taps != (1 if meta.axis[li] is None else 3):
            raise ValueError(f"layer {li}: {taps} taps along {meta.axis[li]}")
        if k > 0 and li != lis[k - 1] + 1:
            raise ValueError(f"layers {lis} do not chain")
    return lis


def _tile_columns(meta: SqnxtMeta, rt: int) -> int:
    """4096 / rt columns, halved (the reduction split over thread groups)
    at most twice while N would give fewer than MIN_TILES tiles."""
    ks = 1
    while ks < 4 and -(-meta.n_real // (TILE_OUT // (rt * ks))) < MIN_TILES:
        ks *= 2
    return TILE_OUT // (rt * ks)


def fwd_tile_columns(meta: SqnxtMeta, li: int, tc: bool = False) -> int:
    """Columns of one forward tile of layer li (csrc/sqnxt_tiles.cuh's
    tn_f): ``_tile_columns`` at RT, the layer's rows rounded up to 8-128;
    ``tc`` (the bf16 instances on the tensor cores): at least
    TC_MIN_COLUMNS."""
    tn = _tile_columns(meta, _row_tile(meta.cdims[li + 1]))
    return max(tn, TC_MIN_COLUMNS) if tc else tn


def bwd_tile_columns(meta: SqnxtMeta, li: int, tc: bool = False) -> int:
    """Columns of one backward (pass A and B) tile of layer li
    (csrc/sqnxt_tiles.cuh's tn_b): ``_tile_columns`` at RT, the smaller of
    the rows of Cin and Cout rounded up to 8-128; ``tc``: at least
    TC_MIN_COLUMNS, at most TC_MAX_BWD_COLUMNS."""
    tn = _tile_columns(meta, min(_row_tile(meta.cdims[li]),
                                 _row_tile(meta.cdims[li + 1])))
    return min(max(tn, TC_MIN_COLUMNS), TC_MAX_BWD_COLUMNS) if tc else tn


def _halo(meta: SqnxtMeta, li: int) -> int:
    """Columns layer li's taps reach on each side: 0 for one tap, 1 along
    j, W along i."""
    return 0 if meta.axis[li] is None else (1 if meta.axis[li] == "j"
                                            else meta.W)


def tensor_cores(esize: int) -> bool:
    """Whether a launch runs its products on the tensor cores: every bf16
    instance, the chain's (K6, K7) and the one-layer ones (K8, K9); the
    fp32 instances keep the FFMA tiles (csrc/sqnxt_tiles.cuh's
    kTensorCores)."""
    return esize == 2


def _r(v: int, m: int) -> int:
    return -(-v // m) * m


def tc_geometry(meta: SqnxtMeta, li: int, tn: int) -> dict:
    """csrc/sqnxt_tiles.cuh's tc::geo: layer li's tensor-core tile of tn
    columns in bf16 elements. hr: staged columns each side (the halo, 1
    along j or W along i, rounded up to 8); ldr and ldh: the row strides of
    the raw rows and of the product operands; kf = taps Cin and kb = taps
    Cout rounded up to 16 (the mma's k); cf = Cout and cb = Cin rounded up
    to 8 (its n)."""
    cin, cout = meta.cdims[li], meta.cdims[li + 1]
    taps = len(meta.taps[li])
    hr = 0 if taps == 1 else _r(_halo(meta, li), 8)
    return dict(tn=tn, hr=hr, ldr=tn + 2 * hr + 8, ldh=tn + 8,
                kf=_r(taps * cin, 16), kb=_r(taps * cout, 16),
                cf=_r(cout, 8), cb=_r(cin, 8))


def _ffma_layout(meta, li, backward):
    """(tile floats, weight floats) the FFMA tiles of layer li need
    (csrc/sqnxt_tiles.cuh's plan and plan_fwd)."""
    cin, cout = meta.cdims[li], meta.cdims[li + 1]
    taps = len(meta.taps[li])
    rt_o, rt_i = _row_tile(cout), _row_tile(cin)
    halo = _halo(meta, li)
    tile = max(TILE_OUT, cin * (fwd_tile_columns(meta, li) + 2 * halo))
    w = taps * cin * rt_o
    if backward:
        K, cols = taps * cin, TILE_OUT // rt_o
        sub = -(-K // cols)
        groups = cols // 4 // (-(-K // 4)) if sub == 1 else 1
        ld_b = bwd_tile_columns(meta, li) + 2 * halo
        ld_b = ld_b | 1 if groups == 1 else ld_b + (groups - ld_b) % 32
        tile = max(tile, (cin + cout) * ld_b)
        w = max(w, taps * cout * rt_i)
    return tile, w


def _tc_layout(meta, li, backward):
    """(tile floats, weight floats) of layer li on the tensor cores
    (csrc/sqnxt_tiles.cuh's tc::need): the forward's raw rows (three taps)
    and tap rows (kf x ldh), then its z tile (Cout x tn bf16); the
    backward's z, g and input raw rows and, for three taps, the tap rows of
    g_z (kb) and of the input (kf); weights cf x (kf + 8) forward and cb x
    (kb + 8) for g_h, bf16."""
    cin, cout = meta.cdims[li], meta.cdims[li + 1]
    taps = len(meta.taps[li])
    tn = fwd_tile_columns(meta, li, True)
    g = tc_geometry(meta, li, tn)
    ops = (0 if taps == 1 else cin * g["ldr"]) + g["kf"] * g["ldh"]
    tile = _r(ops // 2, 4) + cout * tn // 2
    w = _r(g["cf"] * (g["kf"] + 8) // 2, 4)
    if backward:
        g = tc_geometry(meta, li, bwd_tile_columns(meta, li, True))
        zr = g["kb"] if taps == 1 else cout
        e = (zr + cout) * g["ldr"] + (
            g["kf"] * g["ldh"] if taps == 1
            else cin * g["ldr"] + (g["kb"] + g["kf"]) * g["ldh"])
        tile = max(tile, _r(e // 2, 4))
        w = max(w, _r(g["cb"] * (g["kb"] + 8) // 2, 4))
    return tile, w


def stage_layout(meta: SqnxtMeta, lis: Sequence[int], esize: int = 4,
                 backward: bool = False) -> Tuple[int, int, bool]:
    """(tile floats, weight floats, tensor cores) of the shared-memory
    regions a launch's plan lays out for the staged tile and the staged
    weights (csrc/sqnxt_fwd.cu's pnode_sqnxt_layout): the most any layer
    of ``lis`` needs, the tile at least TILE_OUT floats, each rounded up to
    4. The bf16 instances take the tensor-core layout (bf16 operands, K
    padded to 16, Cout and Cin to 8; ``_tc_layout``), the fp32 ones the
    FFMA tiles' (``_ffma_layout``)."""
    lis = _chain_layers(meta, lis, 1)
    tc = tensor_cores(esize)
    one = _tc_layout if tc else _ffma_layout
    sizes = [one(meta, li, backward) for li in lis]
    tile = max([TILE_OUT] + [t for t, _ in sizes])
    return _r(tile, 4), _r(max(w for _, w in sizes), 4), tc


def elem_floats(n: int, esize: int) -> int:
    """Floats that n elements of ``esize`` bytes take (csrc's
    elem_floats)."""
    return -(-n * esize // 4)


def fwd_scratch_floats(meta: SqnxtMeta, lis: Sequence[int], grid: int,
                       esize: int = 4) -> int:
    """Floats of K6's (``lis`` = 0..4) or K8's (one layer) scratch for a
    grid of ``grid`` blocks and a storage type of ``esize`` bytes, as
    csrc/sqnxt_tiles.cuh's fwd_scratch_floats counts them: two partial-slot
    buffers (grid x 4 x 128 each), then the anchors Cout x N that go to
    device memory, ``elem_floats(Cout N, esize)`` each. Every layer but the last
    writes one (the next layer's halo comes from other blocks); the last
    writes none where the kernel keeps the z it reads again in shared
    memory: the store (the most one block's tiles of z take, over the last
    layer and those with a centered variance; the bf16 instances' tiles
    are bf16, at least TC_MIN_COLUMNS wide) fits STORE_FLOATS at this
    grid. Raises ValueError for a chain the kernels do not take."""
    lis = _chain_layers(meta, lis, grid)
    N, store, tc = meta.n_real, 0, tensor_cores(esize)
    for k, li in enumerate(lis):
        if k + 1 < len(lis) and meta.single_pass[li]:
            continue
        tn = fwd_tile_columns(meta, li, tc)
        tiles = -(-N // tn)
        store = max(store, -(-tiles // grid) * meta.cdims[li + 1] * tn)
    if tc:  # the bf16 instances' z tiles are bf16
        store = -(-store // 2)
    anchors = [meta.cdims[li + 1] for li in lis[:-1]]
    if store > STORE_FLOATS:
        anchors.append(meta.cdims[lis[-1] + 1])
    return grid * _PARTIAL_FLOATS + sum(elem_floats(c * N, esize)
                                        for c in anchors)


def bwd_scratch_floats(meta: SqnxtMeta, lis: Sequence[int], grid: int,
                       esize: int = 4) -> int:
    """Floats of K7's (``lis`` = 0..4) or K9's (one layer) scratch for a
    grid of ``grid`` blocks and a storage type of ``esize`` bytes, as
    csrc/sqnxt_tiles.cuh's scratch_floats counts them: two partial-slot
    buffers (grid x 4 x 128 each), one dW slot per block (the largest taps
    * Cin * Cout rounded up to 4) and, for the chain, two g buffers of the
    largest Cin * N past the first layer, ``elem_floats(2 Cin N, esize)``.
    Raises ValueError for a chain the kernels do not take (more than 128
    channels, layers that do not chain, a dW too large for three register
    tiles per thread)."""
    lis = _chain_layers(meta, lis, grid)
    dw, gmax = 0, 0
    for k, li in enumerate(lis):
        cin, cout = meta.cdims[li], meta.cdims[li + 1]
        taps = len(meta.taps[li])
        if -(-taps * cin * _row_tile(cout) // TILE_OUT) > MAX_DW_TILES:
            raise ValueError(f"layer {li}: dW of {cout} x {taps * cin} takes "
                             f"more than {MAX_DW_TILES} register tiles")
        dw = max(dw, -(-taps * cin * cout // 4) * 4)
        if k > 0:
            gmax = max(gmax, cin * meta.n_real)
    return grid * _PARTIAL_FLOATS + grid * dw + elem_floats(2 * gmax, esize)


def _suffix(esize: int) -> str:
    """The C entry points' suffix of a storage type."""
    return "_bf16" if esize == 2 else ""


def _c_plan(entry, mirror, meta, lis, device, esize):
    """(grid, scratch floats, ctypes ints) of a launch at this shape from
    the C side's ``entry`` (the co-resident blocks at the launch's shared
    memory, at most its tile count), its scratch checked against
    ``mirror``."""
    mirror(meta, lis, 1, esize)  # refuses what the kernels refuse
    entry += _suffix(esize)
    ints = _build.int_array(_layer_ints(meta, lis))
    grid, floats = _build.int_array([0]), (ctypes.c_longlong * 1)(0)
    with torch.cuda.device(device):
        _build.check(getattr(_build.library(), entry)(
            len(lis), ints, meta.n_real, meta.H, meta.W, grid, floats),
            f"{entry} (cooperative launch)")
    want = mirror(meta, lis, grid[0], esize)
    if floats[0] != want:
        raise RuntimeError(f"{entry}: C counts {floats[0]} scratch floats, "
                           f"{mirror.__name__} {want}")
    return grid[0], floats[0], ints


_fwd_plans = {}
_bwd_plans = {}


def c_stage_layout(meta: SqnxtMeta, lis: Sequence[int], device,
                   esize: int = 4, backward: bool = False):
    """``stage_layout`` as the C plan computes it (pnode_sqnxt_layout)."""
    lis = _chain_layers(meta, lis, 1)
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device):
        _build.check(_build.library().pnode_sqnxt_layout(
            len(lis), _build.int_array(_layer_ints(meta, lis)), meta.n_real,
            meta.H, meta.W, esize, int(backward), out), "pnode_sqnxt_layout")
    return out[0], out[1], bool(out[2])


def fwd_plan(meta: SqnxtMeta, lis: Sequence[int], device, esize: int = 4):
    """(grid, scratch floats, ctypes ints) of K6 or K8 at this shape and a
    storage type of ``esize`` bytes, from csrc/sqnxt_fwd.cu's
    pnode_sqnxt_fwd_plan (_bf16); cached per (meta, layers, esize,
    device)."""
    lis = list(lis)
    key = (meta, tuple(lis), esize, torch.device(device).index)
    if key not in _fwd_plans:
        _fwd_plans[key] = _c_plan("pnode_sqnxt_fwd_plan", fwd_scratch_floats,
                                  meta, lis, device, esize)
    return _fwd_plans[key]


def bwd_plan(meta: SqnxtMeta, lis: Sequence[int], device,
             esize: int = 4) -> Tuple[int, int]:
    """(grid, scratch floats) of K7 or K9 at this shape and storage type,
    from csrc/fused_sqnxt.cu's pnode_sqnxt_bwd_plan (_bf16); cached."""
    lis = list(lis)
    key = (meta, tuple(lis), esize, torch.device(device).index)
    if key not in _bwd_plans:
        _bwd_plans[key] = _c_plan("pnode_sqnxt_bwd_plan", bwd_scratch_floats,
                                  meta, lis, device, esize)[:2]
    return _bwd_plans[key]


def _ptrs(values):
    return (ctypes.c_void_p * len(values))(*values)


def _layer_args(meta, lis, flats, zs, grads=None):
    ptrs = []
    for k, lf in enumerate(flats):
        ptrs += [t.data_ptr() for t in lf] + [zs[k].data_ptr()]
        ptrs += ([t.data_ptr() for t in grads[k]] if grads is not None
                 else [0, 0, 0, 0])
    return _build.int_array(_layer_ints(meta, lis)), _ptrs(ptrs)


def _launch_fwd(entry, x, flats, meta, lis):
    """One launch of K6 or K8 (the bf16 instance for a bf16 x). Two
    allocations: out (x's dtype), and the workspace the plan counts (the
    partial slots, then the anchors, carved by C)."""
    lib = _build.library()
    N, dev, esize = meta.n_real, x.device, esize_of(x.dtype)
    grid, floats, ints = fwd_plan(meta, lis, dev, esize)
    entry += _suffix(esize)
    out = torch.empty(meta.cdims[lis[-1] + 1], N, device=dev, dtype=x.dtype)
    scratch = torch.empty(floats, device=dev)
    ptrs = _ptrs([t.data_ptr() for lf in flats for t in lf])
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), len(lis), ints,
                                 ptrs, N, meta.H, meta.W, scratch.data_ptr(),
                                 floats, grid, _build.stream_of(x))
    _build.check(rc, f"{entry} kernel")
    return out


def _carve(nbytes_first, dtype_first, sizes_first, dtype_rest, sizes_rest,
           device):
    """One byte buffer cut into ``sizes_first`` elements of
    ``dtype_first`` (``nbytes_first`` bytes, a multiple of 16) followed by
    ``sizes_rest`` elements of ``dtype_rest``: one allocation whatever the
    two dtypes."""
    esize = torch.empty(0, dtype=dtype_rest).element_size()
    buf = torch.empty(nbytes_first + esize * sum(sizes_rest),
                      dtype=torch.uint8, device=device)
    first = buf[:nbytes_first].view(dtype_first).split(sizes_first)
    rest = buf[nbytes_first:].view(dtype_rest).split(sizes_rest)
    return list(first), list(rest)


def _launch_bwd(entry, x, g, flats, meta, lis, anchors=False, grid=None):
    """One launch of K7 or K9 (the bf16 instance for a bf16 x). Two
    allocations: the gradients (every layer's dW, db, dgam, dbet in fp32 as
    views of one buffer, and dx in x's dtype) and the workspace (the
    scratch the plan counts, then the anchors z_l in x's dtype).
    ``anchors``: also return the anchors z_l that the launch's forward
    recompute wrote (a check holds the backward against them). ``grid``:
    fewer blocks than the plan's (comparisons of grids only; the partial
    sums then add in another grouping)."""
    lib = _build.library()
    N, dev, esize = meta.n_real, x.device, esize_of(x.dtype)
    want, floats = bwd_plan(meta, lis, dev, esize)
    if grid is None:
        grid = want
    elif not 1 <= grid <= want:
        raise ValueError(f"{entry}: a grid of 1 to {want} blocks, got {grid}")
    else:
        floats = bwd_scratch_floats(meta, lis, grid, esize)
    entry += _suffix(esize)
    sizes = [t.numel() for lf in flats for t in lf]
    cin0 = meta.cdims[lis[0]]
    views, (dx,) = _carve(4 * sum(sizes), torch.float32, sizes, x.dtype,
                          [cin0 * N], dev)
    dx = dx.view(cin0, N)
    grads, k = [], 0
    for lf in flats:
        grads.append(tuple(v.view(t.shape) for v, t in zip(views[k:], lf)))
        k += len(lf)
    zsizes = [meta.cdims[li + 1] * N for li in lis]
    # the scratch first, so it is 16-byte aligned
    (scratch,), zs = _carve(4 * floats, torch.float32, [floats], x.dtype,
                            zsizes, dev)
    ints, ptrs = _layer_args(meta, lis, flats, zs, grads)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), len(lis), ints, ptrs,
            N, meta.H, meta.W, scratch.data_ptr(), floats, grid,
            _build.stream_of(x))
    _build.check(rc, f"{entry} kernel")
    return (dx, grads, zs) if anchors else (dx, grads)


def _count(fn, x):
    """One launch more of ``fn``'s instance for x's dtype."""
    if x.dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def fused_sqnxt_fwd(x, flat, meta):
    """K6: the whole chain, (dim, N) -> (dim, N)."""
    flats = [_layer(flat, li) for li in range(5)]
    if not _check("fused_sqnxt_fwd", x, flats, meta, range(5)):
        return fused_sqnxt_plain(x, flat, meta)
    out = _launch_fwd("pnode_sqnxt_fwd", x, flats, meta, list(range(5)))
    _count(fused_sqnxt_fwd, x)
    return out


def fused_sqnxt_bwd(x, g, flat, meta):
    """K7: (dx, dflat) of the chain at x for the output cotangent g (dx in
    x's dtype, dflat in fp32)."""
    flats = [_layer(flat, li) for li in range(5)]
    if not _check("fused_sqnxt_bwd", x, flats, meta, range(5), g):
        return fused_sqnxt_bwd_plain(x, g, flat, meta)
    dx, grads = _launch_bwd("pnode_sqnxt_bwd", x, g, flats, meta,
                            list(range(5)))
    _count(fused_sqnxt_bwd, x)
    return dx, tuple(t for lg in grads for t in lg)


def fused_sqnxt_layer_fwd(h, layer_flat, meta, li):
    """K8: layer li alone, (Cin, N) -> (Cout, N)."""
    if not _check("fused_sqnxt_layer_fwd", h, [layer_flat], meta, [li]):
        return fused_sqnxt_layer_plain(h, layer_flat, meta, li)
    out = _launch_fwd("pnode_sqnxt_fwd_layer", h, [layer_flat], meta, [li])
    _count(fused_sqnxt_layer_fwd, h)
    return out


def fused_sqnxt_layer_bwd(h, g, layer_flat, meta, li):
    """K9: (dh, (dW, db, dgam, dbet)) of layer li from its saved input."""
    if not _check("fused_sqnxt_layer_bwd", h, [layer_flat], meta, [li], g):
        return fused_sqnxt_layer_bwd_plain(h, g, layer_flat, meta, li)
    dh, grads = _launch_bwd("pnode_sqnxt_bwd_layer", h, g, [layer_flat],
                            meta, [li])
    _count(fused_sqnxt_layer_bwd, h)
    return dh, grads[0]


for _fn in (fused_sqnxt_fwd, fused_sqnxt_bwd, fused_sqnxt_layer_fwd,
            fused_sqnxt_layer_bwd):
    _fn.launches = 0
    _fn.launches_bf16 = 0


def _grads_like(dflat, flat):
    return [d.to(f.dtype) for d, f in zip(dflat, flat)]


class _ChainFn(torch.autograd.Function):
    """out = chain(x); backward = K7 (the JAX package's _core)."""

    @staticmethod
    def forward(ctx, meta, x, *flat):
        ctx.meta = meta
        ctx.save_for_backward(x, *flat)
        return fused_sqnxt_fwd(x, flat, meta)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        dx, dflat = fused_sqnxt_bwd(x, g.contiguous(), flat, ctx.meta)
        return (None, dx.to(x.dtype), *_grads_like(dflat, flat))


class _LayeredFn(torch.autograd.Function):
    """Five K8 launches; backward five K9 launches in reverse from the saved
    layer inputs (the JAX package's _core_layered)."""

    @staticmethod
    def forward(ctx, meta, x, *flat):
        hs, h = [], x
        for li in range(5):
            hs.append(h)
            h = fused_sqnxt_layer_fwd(h, _layer(flat, li), meta, li)
        ctx.meta = meta
        ctx.save_for_backward(*hs, *flat)
        return h

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        hs, flat = saved[:5], saved[5:]
        g = g.contiguous()
        dflat = [None] * len(flat)
        for li in range(4, -1, -1):
            g, d = fused_sqnxt_layer_bwd(hs[li], g, _layer(flat, li),
                                         ctx.meta, li)
            dflat[4 * li: 4 * li + 4] = d
        return (None, g.to(hs[0].dtype), *_grads_like(dflat, flat))


def sqnxt_cost(meta: SqnxtMeta, lis: Sequence[int], backward: bool,
               esize: int = 4):
    """(flops, bytes) a kernel call must do at least, for the roofline bound:
    2 taps Cin Cout N per conv (backward: 3x, the recompute, dW and g_h),
    each input read once and each output written once (forward: x, the
    parameters and out; backward: x, g, the parameters, dx and the
    parameter gradients), activations, taps and b at ``esize`` bytes (the
    storage type), gamma, beta and the gradients in fp32."""
    N = meta.n_real
    conv = sum(2 * len(meta.taps[li]) * meta.cdims[li] * meta.cdims[li + 1] * N
               for li in lis)
    wb = sum(len(meta.taps[li]) * meta.cdims[li] * meta.cdims[li + 1]
             + meta.cdims[li + 1] for li in lis)
    norm = sum(2 * meta.cdims[li + 1] for li in lis)
    params = esize * wb + 4 * norm
    cin, cout = meta.cdims[lis[0]], meta.cdims[lis[-1] + 1]
    if backward:
        return 3 * conv, (esize * (2 * cin * N + cout * N) + params
                          + 4 * (wb + norm))
    return conv, esize * (cin * N + cout * N) + params


def sqnxt_layered_cost(meta: SqnxtMeta, backward: bool, esize: int = 4):
    """(flops, bytes) of one evaluation in the layered mode (K8 or K9): five
    launches, each reading its own layer's input (and cotangent) and
    writing its own output, so sqnxt_cost of each layer alone, summed."""
    costs = [sqnxt_cost(meta, [li], backward, esize) for li in range(5)]
    return sum(c[0] for c in costs), sum(c[1] for c in costs)
