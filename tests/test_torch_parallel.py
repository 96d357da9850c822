"""Data parallelism (pnode_tpu_torch.parallel) over gloo ranks: CPU twins of
tests/test_parallel.py and of the pieces of ``__graft_entry__.py``'s
``dryrun_multichip`` that the port runs.

One group of 8 ranks (``run_ranks``, spawned, under its deadline; the
counterpart of the reference's 8-device virtual CPU mesh) runs every case
once (tests/torch_dp_ranks.py ``suite_rank``); each test reads its case:

- y' = tanh(y w), rk4, B 16, D 8, fp64, on the flat mesh (:18) and on a
  2 x 4 ("dcn", "dp") mesh sharded over both axes (:60); dopri5 under
  -ts_adapt_type basic on identical shards (:144), and rk4 under revolve
  checkpointing (-ts_trajectory_max_cps_ram 3, step 0.05, an interior
  output in the loss: :105), both marked slow in the reference, their
  twins running in seconds at B 16, D 8. DP loss and gradient against
  JAX's single-device value_and_grad at the reference's rtol 1e-12 and
  1e-10.
- The mesh validation errors (:54, :96).
- dryrun_multichip's train step on the KS IMEX model (flax weights through
  state_dict_from_flax), one Adam step: the flat and 2 x 4 meshes,
  adaptive stepping, the headline shapes (nx 64, B 256 over 8 ranks), and
  fp64 loss equality against the single-process solve at rel < 1e-13; the
  fused loop over 8 ranks against K4's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu import Func, ODESolver
from pnode_tpu_torch.convert import state_dict_from_flax
from pnode_tpu_torch.ops.fused_train_loop import fused_train_loop_plain
from pnode_tpu_torch.parallel import run_ranks
from torch_dp_ranks import suite_rank

torch.set_num_threads(1)
N_RANKS = 8
B, D = 16, 8
T_OUT = [0.0, 0.5]


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pt.clear_options()
    yield
    pt.clear_options()


def _tanh_problem():
    w = np.random.default_rng(0).normal(size=(D, D)) * 0.1
    y0 = np.random.default_rng(1).normal(size=(B, D))
    return w, y0, 0.9 * y0


def _adaptive_problem():
    w = np.random.default_rng(0).normal(size=(D, D)) * 0.1
    shard = np.random.default_rng(1).normal(size=(2, D))
    y0 = np.tile(shard, (N_RANKS, 1))  # identical per rank
    return w, y0, 0.9 * y0


ADAPT = ["-ts_adapt_type", "basic", "-ts_rtol", "1e-8", "-ts_atol", "1e-8"]
REVOLVE = ["-ts_trajectory_max_cps_ram", "3", "-ts_trajectory_schedule",
           "revolve"]
TANH_CASES = {
    # name: (flags, method, step, mesh_shape, axis, problem)
    "flat": ([], "rk4", 0.1, None, "dp", _tanh_problem),
    "dcn_dp": ([], "rk4", 0.1, (2, 4), ("dcn", "dp"), _tanh_problem),
    "dp_of_dcn_dp": ([], "rk4", 0.1, (2, 4), "dp", _tanh_problem),
    "adaptive": (ADAPT, "dopri5", 0.1, None, "dp", _adaptive_problem),
    "revolve": (REVOLVE, "rk4", 0.05, None, "dp", _tanh_problem),
}
# output times (the loss adds mean(pred[1]^2) where there are three)
TANH_T_OUT = {"revolve": [0.0, 0.25, 0.5]}
KS_CASES = {
    # name: (flags, nx, per rank, dtype, mesh_shape, axis)
    "flat": ([], 16, 2, "float32", None, "dp"),
    "dcn_dp": ([], 16, 2, "float32", (2, 4), ("dcn", "dp")),
    "adaptive": (["-ts_adapt_type", "basic", "-ts_rtol", "1e-6", "-ts_atol",
                  "1e-6"], 16, 2, "float32", None, "dp"),
    "headline": ([], 64, 32, "float32", None, "dp"),
    "fp64": ([], 16, 4, "float64", None, "dp"),
}


def _ks_case(name):
    """The case's numpy inputs and JAX's single-device loss and gradients
    on the whole batch (__graft_entry__._build_ks, use_pallas=False)."""
    flags, nx, per_rank, dtype, _, _ = KS_CASES[name]
    jdt = getattr(jnp, dtype)
    batch = per_rank * N_RANKS
    ode, (vim, vex), _ = graft._build_ks(batch, nx, jdt, use_pallas=False,
                                         extra_flags=flags)
    rng = np.random.default_rng(2)
    y0 = rng.normal(size=(batch, nx)).astype(dtype)
    tgt = (0.9 * y0).astype(dtype)

    def loss_fn(vex_, y, t):
        pred, _ = ode.solve(y, np.array([0.0, 0.2]), params=(vim, vex_))
        return jnp.mean((pred[-1] - t) ** 2)

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(vex, jnp.asarray(y0),
                                                    jnp.asarray(tgt))
    state = {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, vex)).items()}
    pnode_tpu.clear_options()
    return state, y0, tgt, float(loss), g


def _fused_case():
    """dryrun's _run_fused_dp operands: 32 x 64 per rank (B 256), K 4."""
    from test_torch_fused_dp import _build

    batch, nx, K = 32 * N_RANKS, 64, 4
    ops = _build(batch, nx, hidden=104)
    rng = np.random.default_rng(5)
    y = rng.normal(size=(K, batch, nx)).astype(np.float32)
    return ops, y, (y + 0.05 * rng.normal(size=y.shape)).astype(np.float32)


_SUITE = {}


def _suite():
    """Every case through one group of 8 ranks, with the JAX references."""
    if not _SUITE:
        tanh = {n: (f, m, s, ms, ax, *prob()) + (TANH_T_OUT.get(n, T_OUT),)
                for n, (f, m, s, ms, ax, prob) in TANH_CASES.items()}
        refs, ks = {}, {}
        for name, (flags, nx, _, dtype, ms, ax) in KS_CASES.items():
            # the 2 x 4 mesh's problem is the flat mesh's
            state, y0, tgt, loss, g = (_ks_case(name) if name != "dcn_dp"
                                       else refs["flat"][2])
            refs[name] = (loss, g, (state, y0, tgt, loss, g))
            ks[name] = (flags, nx, 104, dtype, ms, ax, state, y0, tgt)
        fused = _fused_case()
        _SUITE["ranks"] = run_ranks(N_RANKS, suite_rank, tanh, ks, fused,
                                    timeout=240.0)
        _SUITE.update(tanh=tanh, ks=ks, refs=refs, fused=fused)
    return _SUITE


def _jax_tanh(name):
    flags, method, step, _, _, w, y0, tgt, t_out = _suite()["tanh"][name]
    pnode_tpu.clear_options()
    pnode_tpu.init(["p"] + list(flags))
    P = {"w": jnp.asarray(w)}
    ode = ODESolver()
    ode.setupTS(jnp.zeros((B // N_RANKS, D)),
                Func(lambda t, y, p: jnp.tanh(y @ p["w"]), P),
                step_size=step, method=method)

    def loss_fn(p, batch):
        pred, _ = ode.solve(batch[0], jnp.asarray(t_out), params=p)
        interior = jnp.mean(pred[1] ** 2) if len(t_out) > 2 else 0.0
        return jnp.mean((pred[-1] - batch[1]) ** 2) + interior

    loss, g = jax.value_and_grad(loss_fn)(P, (jnp.asarray(y0),
                                              jnp.asarray(tgt)))
    return float(loss), np.asarray(g["w"])


@pytest.mark.parametrize("name", sorted(TANH_CASES))
def test_dp_matches_single_device(name):
    """Twins of tests/test_parallel.py:18 (flat), :60 (2 x 4, sharded over
    ("dcn", "dp")), :144 (adaptive, identical shards) and :105 (revolve:
    the schedule depends on the step index only, so every rank replays the
    same plan): every rank's DP loss and gradient equal JAX's
    single-device ones; rank r holds rows 2r .. 2r + 1 (JAX's device
    order). On the 2 x 4 mesh sharded over "dp" alone, each "dcn" row of
    ranks holds the whole batch, rank r rows 4 (r % 4) .. + 3, and the
    mean runs over each row's "dp" group."""
    suite = _suite()
    loss_1, g_1 = _jax_tanh(name)
    y0 = suite["tanh"][name][6]
    rows = 4 if name == "dp_of_dcn_dp" else 2
    for r, res in enumerate(suite["ranks"]):
        loss, g, local, kind = res["tanh"][name]
        assert kind == ("revolve" if name == "revolve" else
                        "store_all"), kind
        shard = (r % 4) if name == "dp_of_dcn_dp" else r
        np.testing.assert_array_equal(local,
                                      y0[rows * shard:rows * (shard + 1)])
        np.testing.assert_allclose(loss, loss_1, rtol=1e-12)
        np.testing.assert_allclose(g, g_1, rtol=1e-10)


@pytest.mark.parametrize("name, match", [
    ("overallocation", "available"), ("axis_names", "match axis_names"),
    ("needs", "needs")])
def test_make_mesh_validation(name, match):
    """Twins of :54 (more ranks asked for than exist) and :96 (bad
    shapes)."""
    for res in _suite()["ranks"]:
        assert match in res["errors"][name]


# the gradients' L2 error over all parameters against JAX's single device:
# fp32 at nx 16 reads ~3e-7; at the headline (nx 64, hidden 104) the KS
# init's ~1e-9 weight gradients are sums that cancel, and summing them as
# 8 local means moves the hidden layers' by ~2% (L2 over all, 2e-3); fp64
# reads ~5e-16
GRAD_TOL = {"headline": 5e-3, "fp64": 1e-12}


def _flat(ts):
    return np.concatenate([np.ravel(t) for t in ts])


@pytest.mark.parametrize("name", sorted(KS_CASES))
def test_dryrun_multichip_ks_step(name):
    """dryrun_multichip's DP train step on the port, one case per piece:
    the DP loss against JAX's single-device loss on the whole batch (fp32
    rtol 1e-5, fp64 1e-12; adaptive: each rank's controller runs on its own
    shard, the reference's COMM_SELF semantics, so the schedule and the
    loss part at the tolerance's scale: 1e-4), the gradients as GRAD_TOL
    says, and the updated parameters bitwise equal on every rank."""
    suite = _suite()
    loss_1, g_1, _ = suite["refs"][name]
    g_1 = {k: np.asarray(v) for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, g_1)).items()}
    g_1 = [g_1[k] for k in sorted(g_1)]
    rtol = {"fp64": 1e-12, "adaptive": 1e-4}.get(name, 1e-5)
    first = suite["ranks"][0]["ks"][name]
    for res in suite["ranks"]:
        loss, grads, params = res["ks"][name]
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, loss_1, rtol=rtol)
        if name != "adaptive":
            err = np.linalg.norm(_flat(grads) - _flat(g_1)) / np.linalg.norm(
                _flat(g_1))
            assert err <= GRAD_TOL.get(name, 1e-5), err
        for a, b in zip(params, first[2]):
            np.testing.assert_array_equal(a, b)


def test_dryrun_fp64_loss_equals_single_process():
    """dryrun_multichip's fp64 check: the 8-rank DP loss equals the port's
    single-process loss on the same global batch at rel < 1e-13."""
    from pnode_tpu_torch.models import KSFuncEX, KSFuncIM

    suite = _suite()
    flags, nx, hidden, _, _, _, state, y0, tgt = suite["ks"]["fp64"]
    pt.init(["p", "-snes_type", "ksponly", "-ksp_rtol", "1e-6"])
    ex = KSFuncEX(nx=nx, hidden=hidden).double()
    ex.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    ode = pt.ODESolver()
    ode.setupTS(torch.zeros(len(y0), nx, dtype=torch.float64),
                pt.TorchFunc(KSFuncIM(nx=nx).double()), step_size=0.2,
                method="imex", imex_form=True, func2=pt.TorchFunc(ex),
                linear_solver="hpddm", fixed_jacobian=True,
                batch_size=len(y0))
    pred = ode.odeint(torch.from_numpy(y0), np.array([0.0, 0.2]))
    loss = float(torch.mean((pred[-1] - torch.from_numpy(tgt)) ** 2))
    for res in suite["ranks"]:
        assert abs(res["ks"]["fp64"][0] - loss) / abs(loss) < 1e-13


def test_dryrun_fused_dp_matches_k4():
    """dryrun_multichip's fused piece: dp_fused_train_loop over 8 ranks at
    the headline per-rank shape (32 x 64, B 256, hidden 104, K 4) against
    K4's plain version on the whole batch: the losses at the reference's
    rtol 2e-5, and the parameters in chip_smoke phase 4(a)'s form (max abs
    5e-4: the KS init's gradients sit below Adam's eps, where its step
    passes a gradient's rounding on amplified by up to lr/eps), bitwise
    equal across ranks."""
    suite = _suite()
    (tbl, J, inv, Ws, bs, act, sign), y, tgt = suite["fused"]
    t = torch.from_numpy
    Wt, bt = [t(w) for w in Ws], [t(b) for b in bs]
    z = ([torch.zeros_like(w) for w in Wt], [torch.zeros_like(b) for b in bt])
    ref = fused_train_loop_plain(tbl, float(np.float32(0.2)), t(y), t(tgt),
                                 t(J), t(inv), Wt, bt, z, z, 0, act, sign,
                                 lr=5e-3)
    first = suite["ranks"][0]["fused"]
    np.testing.assert_allclose(first["losses"], ref[4].numpy(), rtol=2e-5,
                               atol=1e-8)
    err = np.abs(_flat(first["Ws"] + first["bs"])
                 - _flat([p.numpy() for p in ref[0] + ref[1]])).max()
    assert err <= 5e-4, err
    for res in suite["ranks"]:
        assert res["fused"]["shapes"] == [(32, 64)] * 4
        for a, b in zip(res["fused"]["Ws"] + res["fused"]["bs"],
                        first["Ws"] + first["bs"]):
            np.testing.assert_array_equal(a, b)
