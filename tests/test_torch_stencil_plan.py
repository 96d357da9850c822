"""K10/K11's launch plan, their wrappers' route to the kernel library, and
the fixed stencil's cached cast.

``stencil_plan`` (ops/circular_stencil.py) mirrors the C plan
(csrc/circular_stencil.cu make_plan, entry point pnode_stencil_plan): the
body (1 the register tile, 0 the staged rows), rows per warp, rows per
block and grid. The pinned tuples are the C plan's on an H100 (132 SMs),
which chip_smoke.py's build phase holds against this mirror at the same
shapes. The wrappers are driven through a stand-in library with tensors
that report a CUDA device (none is present here): one C call per wrapper
call in every mode, dw's scratch sized from the plan.
"""

import numpy as np
import pytest
import torch

import pnode_tpu_torch.ops.circular_stencil as cs
from pnode_tpu_torch.models import BurgersFuncIM, CircularConv1D
from pnode_tpu_torch.ops import _build

torch.set_num_threads(1)
SMS = 132

# chip_smoke.py's STENCIL_CASES: (rows, N, k) -> the C plan at 132 SMs
CASES = [
    ((200, 512, 3), (1, 1, 1, 200)),    # Burgers stage: a warp a row
    ((256, 64, 5), (1, 2, 2, 128)),     # KS stage: a half-warp a row
    ((37, 100, 7), (0, 0, 10, 4)),      # ragged: N/4 = 25 on one lane
    ((3, 13001, 5), (0, 0, 1, 3)),      # wide: N % 4
    ((5, 3, 7), (0, 0, 64, 1)),         # wrapped: N % 4
    ((4096, 512, 3), (1, 1, 8, 512)),   # many blocks: 8 warps a block
    ((33, 8, 9), (1, 16, 16, 3)),       # k > N on the tile
    ((70, 4, 6), (1, 32, 32, 3)),       # even k, a lane a row
]


# with dw, the register tile takes 8 warps a block
DW_CASES = {(200, 512, 3): (1, 1, 8, 25), (256, 64, 5): (1, 2, 16, 16),
            (4096, 512, 3): (1, 1, 8, 512), (33, 8, 9): (1, 16, 128, 1),
            (70, 4, 6): (1, 32, 256, 1)}


@pytest.mark.parametrize("shape, plan", CASES,
                         ids=[f"{r}x{n}-k{k}" for (r, n, k), _ in CASES])
def test_mirror_pins_the_c_plan(shape, plan):
    assert cs.stencil_plan(*shape, SMS) == plan
    assert cs.stencil_plan(*shape, SMS, need_dw=True) == DW_CASES.get(
        shape, plan)


# at 200 rows, k 1-7: the body and grid by N
BY_N = {1: (0, 0, 64, 4), 3: (0, 0, 64, 4), 64: (1, 2, 2, 100),
        100: (0, 0, 10, 20), 512: (1, 1, 1, 200), 13001: (0, 0, 1, 200)}


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("n", sorted(BY_N))
def test_plan_by_row_length_and_taps(n, k):
    assert cs.stencil_plan(200, n, k, SMS) == BY_N[n]
    # an operand off 16 bytes, or k > 9, takes the staged rows
    rpb = max(1, min(64, 1024 // n))
    staged = (0, 0, rpb, -(-200 // rpb))
    assert cs.stencil_plan(200, n, k, SMS, aligned=False) == staged
    assert cs.stencil_plan(200, n, k + 10, SMS) == staged


@pytest.mark.parametrize("n, lanes", [(4, 1), (8, 2), (12, 0), (16, 4),
                                      (64, 16), (96, 0), (128, 32),
                                      (256, 32), (384, 0), (512, 32),
                                      (1024, 0), (100, 0), (13001, 0)])
def test_tile_lanes(n, lanes):
    """A row on the largest power-of-two lanes dividing N/4, 1, 2 or 4
    float4s a lane; 0 (the staged rows) otherwise."""
    assert cs.tile_lanes(n) == lanes


@pytest.mark.parametrize("sms, plan", [(1, (1, 1, 8, 512)),
                                       (132, (1, 1, 8, 512)),
                                       (600, (1, 1, 4, 1024)),
                                       (5000, (1, 1, 1, 4096))])
def test_warps_per_block_follow_the_sm_count(sms, plan):
    """The most warps a block (8, 4, 2, 1) that still give a block per SM;
    every row covered once."""
    assert cs.stencil_plan(4096, 512, 3, sms) == plan
    body, per_warp, per_block, grid = plan
    assert (grid - 1) * per_block < 4096 <= grid * per_block


@pytest.mark.parametrize("shape", [c[0] for c in CASES[:2]])
def test_stage_shapes_run_the_tile_over_50_blocks(shape):
    body, _, _, grid = cs.stencil_plan(*shape, SMS)
    assert body == 1 and grid >= 50


# -- the wrappers' route, through a stand-in library ------------------------

class _CudaStyle(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_style(a):
    return torch.Tensor._make_subclass(_CudaStyle, torch.from_numpy(a))


class _Lib:
    """Records each C call and answers the plan as the mirror does."""

    def __init__(self):
        self.calls = []

    def pnode_stencil_plan(self, rows, n, k, aligned, need_dw, out):
        out[:] = cs.stencil_plan(rows, n, k, SMS, bool(aligned),
                                 bool(need_dw))
        return 0

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(_build, "stream_of", lambda t: 7)
    # the current device is the operands' (the CPU build has no getter)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)

    def no_switch(device):
        raise AssertionError("entered torch.cuda.device on the current "
                             "device")
    monkeypatch.setattr(torch.cuda, "device", no_switch)

    def plan(rows, n, k, device, aligned=True, need_dw=False):
        out = [0] * 4
        fake.pnode_stencil_plan(rows, n, k, aligned, need_dw, out)
        return tuple(out)
    monkeypatch.setattr(cs, "plan", plan)
    scratch = []

    def dw_scratch(device, stream, words):
        buf = torch.zeros(words, dtype=torch.int32)
        scratch.append((device, stream, words))
        return buf
    monkeypatch.setattr(cs, "dw_scratch", dw_scratch)
    # the stand-in's launches count from 0 and leave the counts as found
    monkeypatch.setattr(cs.circular_stencil_fwd, "launches", 0)
    monkeypatch.setattr(cs.circular_stencil_bwd, "launches", 0)
    cs._dw_words.cache_clear()
    fake.scratch = scratch
    yield fake
    cs._dw_words.cache_clear()


@pytest.mark.parametrize("rows, n, k", [c[0] for c in CASES[:3]])
def test_one_c_call_per_wrapper_call(lib, rows, n, k):
    rng = np.random.default_rng(rows)
    y, g = (_cuda_style(rng.normal(size=(rows, n)).astype(np.float32))
            for _ in range(2))
    w = _cuda_style(rng.uniform(-1, 1, size=k).astype(np.float32))
    cs.circular_stencil_fwd(y, w)
    dy, no_dw = cs.circular_stencil_bwd(y, g, w, need_dw=False)
    dy, dw = cs.circular_stencil_bwd(y, g, w)
    assert [c[0] for c in lib.calls] == [
        "pnode_stencil_fwd", "pnode_stencil_bwd", "pnode_stencil_bwd"]
    assert lib.calls[0][1][3:] == (rows, n, k, 7)
    # without dw: no scratch, no dw pointer
    assert lib.calls[1][1][4:] == (None, None, 0, rows, n, k, 0, 7)
    # with dw: the counter's 4 words and k partials per block of the plan
    grid = cs.stencil_plan(rows, n, k, SMS, need_dw=True)[3]
    assert lib.calls[2][1][6:] == (4 + k * grid, rows, n, k, 1, 7)
    assert lib.scratch == [(torch.device("cuda", 0), 7, 4 + k * grid)]
    assert no_dw is None and tuple(dw.shape) == (k,)
    assert cs.circular_stencil_fwd.launches == 1
    assert cs.circular_stencil_bwd.launches == 2


def test_dw_scratch_is_kept_per_device_and_stream(monkeypatch):
    monkeypatch.setattr(cs, "_dw_scratch", {})
    cpu = torch.device("cpu")
    a = cs.dw_scratch(cpu, 1, 40)
    assert a.dtype == torch.int32 and int(a.abs().sum()) == 0
    assert cs.dw_scratch(cpu, 1, 12) is a       # reused, never cleared
    b = cs.dw_scratch(cpu, 2, 12)                # another stream
    assert b is not a
    c = cs.dw_scratch(cpu, 1, 400)               # a larger grid: grown
    assert c is not a and c.numel() == 400
    assert cs.dw_scratch(cpu, 1, 40) is c


# -- the fixed stencil's cached cast ----------------------------------------

def test_fixed_stencil_cast_is_cached_and_exact():
    conv = BurgersFuncIM(nx=16, use_fused=True).conv
    assert conv.fixed.dtype == torch.float64
    y32 = torch.zeros(2, 16)
    cast = conv.fixed_as(y32)
    assert cast.dtype == torch.float32
    assert torch.equal(cast, conv.fixed.to(torch.float32))
    assert conv.fixed_as(y32) is cast            # no copy on a later call
    y64 = torch.zeros(2, 16, dtype=torch.float64)
    c64 = conv.fixed_as(y64)                     # another dtype
    assert c64.dtype == torch.float64 and torch.equal(c64, conv.fixed)
    meta = torch.zeros(2, 16, device="meta")     # another device
    cm = conv.fixed_as(meta)
    assert cm.device.type == "meta" and cm.dtype == torch.float32
    conv.to("meta")                              # the buffer moves
    assert conv.fixed_as(meta) is not cm


@pytest.mark.parametrize("use_fused", [True, False])
def test_module_uses_the_cast_stencil(use_fused):
    """CircularConv1D's output through the cached cast equals the op with
    the stencil cast per call, bitwise."""
    rng = np.random.default_rng(3)
    conv = CircularConv1D(5, rng.normal(size=5), use_fused=use_fused)
    y = torch.tensor(rng.normal(size=(4, 24)), dtype=torch.float32)
    ref = cs.circular_stencil_plain(y, conv.fixed.to(torch.float32))
    assert torch.equal(conv(y), ref)
    assert torch.equal(conv(y), ref)
