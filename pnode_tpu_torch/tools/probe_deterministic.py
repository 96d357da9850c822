"""Which of the GRAND path's scatter ops raise on the card under
``torch.use_deterministic_algorithms(True)``, and whether two spmm's at
Cora's scale agree bitwise (``index_add`` sums by atomics on CUDA).

Run on a machine with the card, from the repository root::

    python -m pnode_tpu_torch.tools.probe_deterministic

The graph is ``synthetic_sbm`` at Cora's scale (2,708 nodes, 1,433
features, 7 classes; chip_smoke.py phase 15's surrogate) with random-walk
weights; the state is (2,708, 64) fp32 and the attention scores (E, 4).
The last line printed is a JSON object of the readings.
"""

from __future__ import annotations

import json

CORA = dict(n_nodes=2708, n_classes=7, feat_dim=1433, p_in=0.0082,
            p_out=0.00032, seed=0)


def probe(device="cuda"):
    import torch

    from ..models.grand import get_rw_adj, segment_softmax, spmm, synthetic_sbm

    n = CORA["n_nodes"]
    data = synthetic_sbm(**CORA)
    g = get_rw_adj(data["edge_index"], n).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(n, 64, device=device, generator=gen, requires_grad=True)
    s = torch.randn(g.edge_index.shape[1], 4, device=device, generator=gen,
                    requires_grad=True)
    seg = g.edge_index[0]
    with torch.no_grad():
        a, b = spmm(g, g.edge_weight, x), spmm(g, g.edge_weight, x)
    repeat = float((a - b).abs().max())
    ops = {
        "index_add (spmm forward)": lambda: spmm(g, g.edge_weight, x),
        "spmm backward": lambda: torch.autograd.grad(
            spmm(g, g.edge_weight, x).sum(), x),
        "scatter_reduce amax": lambda: s.new_full(
            (n, 4), float("-inf")).scatter_reduce(
                0, seg[:, None].expand_as(s), s.detach(), "amax",
                include_self=False),
        "segment_softmax forward and backward": lambda: torch.autograd.grad(
            segment_softmax(s, seg, n).pow(2).sum(), s),
    }
    out = {}
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for name, fn in ops.items():
            try:
                fn()
                torch.cuda.synchronize()
                out[name] = "runs"
            except RuntimeError as e:  # the refusal this probe looks for
                out[name] = "raises: " + str(e).strip().splitlines()[0][:100]
    finally:
        torch.use_deterministic_algorithms(before)
    print(f"two spmm's at Cora's scale (E {g.edge_index.shape[1]}, width 64, "
          f"fp32): max |diff| {repeat:.3e}")
    for k, v in out.items():
        print(f"under use_deterministic_algorithms(True): {k}: {v}")
    return {"device": torch.cuda.get_device_name(0),
            "spmm_repeat_max_diff": repeat, "deterministic": out}


if __name__ == "__main__":
    print(json.dumps(probe()))
