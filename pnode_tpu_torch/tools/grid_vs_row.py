"""K2's and K12's grid form against their row form off Burgers-512.

Run on a machine with the card, from the repository root::

    python -m pnode_tpu_torch.tools.grid_vs_row

At states of width 200 to 384 (ARK3, dt 0.2, J = -2 A A^T / d, the stage
inverse formed in fp64, weights N(0, 1 / fan_in)), where K3's plan takes
the grid form and K2's and K12's take it from ``GRID_MIN_D`` up, it runs
both kernels in each form: the grid form (``form="grid"``) and the row
form at the rows per block its rule takes at that batch. It prints each
one's device microseconds per call by the profiler, its relative error
against the plain version, and whether K2's two forms agree bitwise; the
last line is a JSON object of the readings. The plans' width floor
(``csrc/ark_grid.cuh`` kGridMinD) rests on these readings.
"""

from __future__ import annotations

import json

SHAPES = ((37, 200, [200, 200]), (37, 197, [201, 197]),
          (37, 240, [240, 240]), (37, 256, [256]), (37, 280, [280]),
          (37, 300, [300]), (37, 300, [300, 300]), (37, 384, [384]),
          (200, 200, [200, 200]), (200, 300, [300]))


def main(argv=None):
    import numpy as np
    import torch

    import chip_smoke as cs
    from ..ops import _build
    from ..ops.fused_ark_adjoint import (REV_GRAD, _ark_fwd_plan,
                                         rev_plan_full, sm_count)
    from ..ops.fused_ark_forward import fused_ark_step_fwd_plain, run_ark_fwd
    from ..ops.fused_train_loop import (LoopLayout, fused_grad_step_plain,
                                        run_grad_step)
    from ..tableaus import get_ark_tableau

    if not torch.cuda.is_available():
        raise SystemExit("grid_vs_row needs a CUDA card")
    dev = torch.device("cuda", 0)
    lib, sms = _build.library(), sm_count(dev)
    t = get_ark_tableau("3")
    tab = ([[float(x) for x in r] for r in t.a_im],
           [[float(x) for x in r] for r in t.a_ex],
           [float(x) for x in t.b_im], [float(x) for x in t.b_ex])
    dt = float(np.float32(0.2))
    gamma = [g for g in np.diag(t.a_im) if g != 0.0][0]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device=dev)
    print(f"[grid_vs_row] {torch.cuda.get_device_name(0)}, {sms} SMs")
    out = {}
    for B, d, layers in SHAPES:
        rng = np.random.default_rng(d + B)
        A = rng.normal(size=(d, d))
        J64 = -2.0 * (A @ A.T) / d
        J, inv = f32(J64), f32(np.linalg.inv(np.eye(d) - dt * gamma * J64))
        dims = [d] + layers
        Ws = [f32(rng.normal(0, a ** -0.5, size=(a, b)))
              for a, b in zip(dims, dims[1:])]
        bs = [f32(rng.normal(0, 0.1, size=b)) for b in dims[1:]]
        y = f32(rng.normal(size=(B, d)))
        tgt = y + 0.05 * f32(rng.normal(size=(B, d)))
        layout = LoopLayout(B, d, layers)
        params = layout.pack(Ws, bs)
        stream = _build.stream_of(y)
        r2 = _ark_fwd_plan(B, d, tuple(layers), 4, sms)[0]
        r12 = rev_plan_full(B, d, tuple(layers), 4, sms, REV_GRAD)[0]
        k2 = lambda **kw: run_ark_fwd(  # noqa: E731
            lib, sms, stream, tab, None, dt, y, J, inv, Ws, bs, **kw)
        k12 = lambda **kw: run_grad_step(  # noqa: E731
            lib, sms, stream, layout, tab, dt, y, tgt, J, inv, params, **kw)
        label = f"B {B} {dims}"
        row = {}
        for name, fn, rows, plain, names in (
                ("K2", k2, r2,
                 fused_ark_step_fwd_plain(tab, dt, y, J, inv, Ws, bs),
                 (["ark_fwd_grid_kernel"], ["ark_fwd_kernel"])),
                ("K12", k12, r12,
                 fused_grad_step_plain(layout, tab, dt, y, tgt, J, inv,
                                       params),
                 (["grad_step_grid_kernel"],
                  ["grad_step_kernel", "grad_step_sum_kernel"]))):
            grid = lambda fn=fn: fn(form="grid")  # noqa: E731
            rowf = lambda fn=fn, r=rows: fn(rows=r)  # noqa: E731
            g, r = grid(), rowf()
            torch.cuda.synchronize()
            eg = max(cs.rel_err(a, b) for a, b in zip(g, plain))
            er = max(cs.rel_err(a, b) for a, b in zip(r, plain))
            tg = cs.device_us_per_call(grid, names[0])[0]
            tr = cs.device_us_per_call(rowf, names[1])[0]
            row[name] = dict(grid_us=tg, row_us=tr, row_rows=rows,
                             grid_err=eg, row_err=er,
                             bitwise=cs.bitwise(g, r))
            print(f"[grid_vs_row] {name} {label}: grid form {tg:.1f} us "
                  f"(rel err {eg:.2e}), row form at R {rows} {tr:.1f} us "
                  f"({er:.2e}); bitwise {row[name]['bitwise']}")
        out[label] = row
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
