"""The PyTorch port's scaffold against the JAX package: import hygiene, and
the numpy-only modules the port carries as copies (tableaus, time grid,
KS data, options database) pinned to their originals."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu.cams as jax_cams
import pnode_tpu.data.spectral as jax_spectral
import pnode_tpu.grid as jax_grid
import pnode_tpu.options as jax_options
import pnode_tpu.order_conditions as jax_oc
import pnode_tpu.revolve as jax_revolve
import pnode_tpu.tableaus as jax_tableaus
import pnode_tpu.utils.metrics as jax_metrics
import pnode_tpu_torch
import pnode_tpu_torch.cams as pt_cams
import pnode_tpu_torch.data.spectral as pt_spectral
import pnode_tpu_torch.grid as pt_grid
import pnode_tpu_torch.options as pt_options
import pnode_tpu_torch.order_conditions as pt_oc
import pnode_tpu_torch.revolve as pt_revolve
import pnode_tpu_torch.tableaus as pt_tableaus
import pnode_tpu_torch.utils.metrics as pt_metrics
from pnode_tpu_torch.misc import tree_add, tree_leaves, tree_map, tree_zeros_like

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = ("ks_torch", "train_cifar10_torch", "burgers_torch",
           "pendulum_dae_torch", "spiral_torch", "spiral_unstable_torch",
           "rober_torch", "ffjord_tabular_torch", "ffjord_toy_torch",
           "ffjord_image_torch")


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pnode_tpu_torch.clear_options()
    yield
    pnode_tpu_torch.clear_options()


def test_import_leaves_jax_out():
    """Importing the port (every module, parallel/ and tools/ included, the
    trainers and chip_smoke) pulls in none of jax, flax, optax or
    pnode_tpu."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import pnode_tpu_torch, pnode_tpu_torch.solver, "
        "pnode_tpu_torch.convert, pnode_tpu_torch.models, "
        "pnode_tpu_torch.data, pnode_tpu_torch.ops.fused_mlp, "
        "pnode_tpu_torch.ops.fused_ark_forward, "
        "pnode_tpu_torch.ops.fused_ark_adjoint, pnode_tpu_torch.ops._build, "
        "pnode_tpu_torch.ops.fused_train_loop, "
        "pnode_tpu_torch.ops.fused_adaptive_loop, pnode_tpu_torch.adaptive, "
        "pnode_tpu_torch.tableaus_ark5, pnode_tpu_torch.tableaus_ark5l, "
        "pnode_tpu_torch.ops.fused_sqnxt, pnode_tpu_torch.models.sqnxt, "
        "pnode_tpu_torch.ops.circular_stencil, "
        "pnode_tpu_torch.steppers, pnode_tpu_torch.utils, "
        "pnode_tpu_torch.parallel, pnode_tpu_torch.parallel.data_parallel, "
        "pnode_tpu_torch.parallel.fused_dp, pnode_tpu_torch.tools, "
        "pnode_tpu_torch.tools.probe_smem_limit, pnode_tpu_torch.revolve, "
        "pnode_tpu_torch.cams, pnode_tpu_torch.native, "
        "pnode_tpu_torch.order_conditions, pnode_tpu_torch.utils.metrics, "
        "pnode_tpu_torch.ffjord, pnode_tpu_torch.ffjord.resnet, "
        "pnode_tpu_torch.ffjord.datasets, pnode_tpu_torch.ffjord.toy_data\n"
        "import chip_smoke\n"
        "import importlib.util as u\n"
        "for name, path in %r:\n"
        "    s = u.spec_from_file_location(name, path)\n"
        "    m = u.module_from_spec(s); s.loader.exec_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'pnode_tpu'))\n"
        "print('BAD', bad)\n"
    ) % (REPO, [(n, os.path.join(REPO, "examples", n + ".py"))
                for n in DRIVERS])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_sources_name_no_jax_package():
    """No source of the port, nor the trainer or chip_smoke, imports jax,
    flax, optax or pnode_tpu (the package, not pnode_tpu_torch)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|pnode_tpu)"
                     r"(\s|\.|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "examples", n + ".py") for n in DRIVERS]
    for root, _, names in os.walk(os.path.join(REPO, "pnode_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pat.search(open(f).read())]
    assert not offenders, offenders


def test_tf32_off_after_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("name", sorted(jax_tableaus._ARK_TABLEAUS))
def test_ark_tableau_equal(name):
    a = jax_tableaus.get_ark_tableau(name)
    b = pt_tableaus.get_ark_tableau(name)
    assert a.name == b.name and a.order == b.order
    assert a.embedded_order == b.embedded_order
    for field in ("a_im", "b_im", "c_im", "a_ex", "b_ex", "c_ex",
                  "b_im_err", "b_ex_err"):
        x, y = getattr(a, field), getattr(b, field)
        if x is None:
            assert y is None, field
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=field)


def test_rk_and_theta_tables_equal():
    for name in jax_tableaus._RK_TABLEAUS:
        a = jax_tableaus.get_rk_tableau(name)
        b = pt_tableaus.get_rk_tableau(name)
        for field in ("a", "b", "c"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
        assert a.order == b.order and a.fsal == b.fsal
        if a.b_err is not None:
            np.testing.assert_array_equal(a.b_err, b.b_err)
    assert jax_tableaus.THETA_METHODS == pt_tableaus.THETA_METHODS


@pytest.mark.parametrize("t_out, step", [
    (np.array([0.0, 1.0]), 0.3),
    (np.array([0.0, 0.2, 0.4, 1.0]), 0.2),
    (np.array([0.0, 1e-4, 1.0]), 0.25),
    (np.array([0.0, 0.5, 1.0]), [0.25, 0.25, 0.1]),
])
def test_build_time_grid_equal(t_out, step):
    a = jax_grid.build_time_grid(t_out, step)
    b = pt_grid.build_time_grid(t_out, step)
    assert a.n_steps == b.n_steps
    np.testing.assert_array_equal(a.ts, b.ts)
    np.testing.assert_array_equal(a.dts, b.dts)
    np.testing.assert_array_equal(a.out_idx, b.out_idx)


def test_build_time_grid_same_failure():
    t_out, step = np.array([0.0, 0.5]), [0.3, 0.3]
    for mod in (jax_grid, pt_grid):
        with pytest.raises(RuntimeError, match="fails to land"):
            mod.build_time_grid(t_out, step)


def test_generate_ks_data_bit_equal():
    a, dta = jax_spectral.generate_ks_data(n_samples=64)
    b, dtb = pt_spectral.generate_ks_data(n_samples=64)
    assert dta == dtb
    np.testing.assert_array_equal(a, b)


def test_generate_burgers_data_bit_equal(tmp_path):
    a, ta = jax_spectral.generate_burgers_data(nx=32, n_ic=3, T=0.4)
    b, tb = pt_spectral.generate_burgers_data(nx=32, n_ic=3, T=0.4,
                                              cache_dir=str(tmp_path))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ta, tb)
    # the same cache file name, read back as written
    c, tc = pt_spectral.generate_burgers_data(nx=32, n_ic=3, T=0.4,
                                              cache_dir=str(tmp_path))
    assert os.listdir(tmp_path) == ["burgers_nx32_ic3_nu0.0008_T0.4_s0.npz"]
    np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(ta, tc)


def test_init_leaves_same_options_left():
    argv = ["prog", "-ts_type", "arkimex", "-snes_type", "ksponly",
            "-foo", "3", "-bar", "--not-a-flag", "pos", "-ts_rtol", "1e-6"]
    rest_j = pnode_tpu.init(list(argv))
    rest_t = pnode_tpu_torch.init(list(argv))
    assert rest_j == rest_t
    for mod in (jax_options, pt_options):
        o = mod.Options()
        assert o.get_string("ts_type") == "arkimex"
        assert o.get_real("ts_rtol", 0.0) == 1e-6
    assert pnode_tpu.options_left() == pnode_tpu_torch.options_left()
    assert pnode_tpu_torch.options_left() == ["bar", "foo", "snes_type"]


def test_options_typed_getters_and_prefix_equal():
    for mod in (jax_options, pt_options):
        mod.clear_options()
        mod.init(["p", "-pnode_inner_ksp_rtol", "1e-9", "-flag", "-n", "7",
                  "-on", "yes"])
        mod.set_option("n", 3)  # command line wins
        o, inner = mod.Options(), mod.Options("pnode_inner_")
        assert inner.get_real("ksp_rtol", 1e-5) == 1e-9
        assert o.get_real("ksp_rtol", 1e-5) == 1e-5
        assert o.get_bool("flag") is True and o.get_bool("on") is True
        assert o.get_int("n") == 7
        with pytest.raises(ValueError):
            mod.init(["p", "-bad", "maybe"])
            o.get_bool("bad")
    jax_options.clear_options()


def test_order_conditions_equal():
    """order_conditions.py: the same colored trees, densities and residuals
    (bitwise) on every ARK tableau at orders 1-5."""
    assert jax_oc.all_conditions(5) == pt_oc.all_conditions(5)
    for tree in pt_oc.all_conditions(5):
        assert jax_oc.tree_density(tree) == pt_oc.tree_density(tree)
        assert jax_oc.tree_order(tree) == pt_oc.tree_order(tree)
    for name in sorted(jax_tableaus._ARK_TABLEAUS):
        tab = jax_tableaus.get_ark_tableau(name)
        for p in range(1, 6):
            np.testing.assert_array_equal(
                jax_oc.residuals(tab.a_im, tab.a_ex, tab.b_im, p),
                pt_oc.residuals(tab.a_im, tab.a_ex, tab.b_im, p))


@pytest.mark.parametrize("n", [1, 2, 5, 17, 64, 100, 333])
def test_revolve_plans_equal(n):
    """revolve.py: plan, cost and the compiled action table element by
    element at c 1, 2, 3, 8, 16."""
    for c in (1, 2, 3, 8, 16):
        assert pt_revolve.revolve_plan(n, c) == jax_revolve.revolve_plan(n, c)
        assert pt_revolve.optimal_cost(n, c) == jax_revolve.optimal_cost(n, c)
        np.testing.assert_array_equal(pt_revolve.compile_actions(n, c),
                                      jax_revolve.compile_actions(n, c))
    assert (pt_revolve.RESTORE, pt_revolve.ADVANCE, pt_revolve.STORE,
            pt_revolve.REVERSE, pt_revolve.DROP) == (
        jax_revolve.RESTORE, jax_revolve.ADVANCE, jax_revolve.STORE,
        jax_revolve.REVERSE, jax_revolve.DROP)


@pytest.mark.parametrize("n", [1, 3, 10, 37, 100, 1500])
def test_cams_plans_equal(n):
    """cams.py: the forward and reverse plans, the cost and the compiled
    tables element by element at m 0, 1, 4, 8, 20 and w 1, 2, 5 (n 1500
    takes the two-level plan), and the stage weight."""
    for m in (0, 1, 4, 8, 20):
        for w in (1, 2, 5):
            if n > jax_cams.EXACT_N_CAP and m < 4:
                # the two-level plan needs a slot per segment, and both
                # emitters recurse once per step of a segment's plain pass
                continue
            fwd, rev = pt_cams.cams_plan(n, m, w)
            assert (fwd, rev) == jax_cams.cams_plan(n, m, w), (m, w)
            assert pt_cams.optimal_cost(n, m, w) == \
                jax_cams.optimal_cost(n, m, w)
            a = pt_cams.compile_plan(fwd, rev, n)
            b = jax_cams.compile_plan(fwd, rev, n)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for aux, state in ((1, 1), (256, 64), (1024, 256), (7, 3), (0, 5)):
        assert pt_cams.stage_weight(aux, state) == \
            jax_cams.stage_weight(aux, state)
    assert (pt_cams.CAPTURE, pt_cams.REVERSE_STAGE) == (
        jax_cams.CAPTURE, jax_cams.REVERSE_STAGE)


def test_metrics_writer_equal(tmp_path):
    """utils/metrics.py: the same metrics.jsonl records (but the clock)."""
    recs = {}
    for name, mod in (("jax", jax_metrics), ("port", pt_metrics)):
        w = mod.MetricsWriter(str(tmp_path / name), use_tensorboard=False)
        w.add_scalar("Train/Loss", 0.5, 1)
        w.add_scalar("Train/Gradient", 3, 2)
        w.close()
        lines = (tmp_path / name / "metrics.jsonl").read_text().splitlines()
        recs[name] = [{k: v for k, v in json.loads(x).items() if k != "ts"}
                      for x in lines]
    assert recs["jax"] == recs["port"]


def test_tree_helpers():
    a = ({"w": torch.ones(2)}, {"x": torch.arange(3.0), "y": torch.ones(1)})
    z = tree_zeros_like(a)
    assert [t.sum().item() for t in tree_leaves(z)] == [0.0, 0.0, 0.0]
    s = tree_add(a, a)
    assert torch.equal(s[1]["x"], 2 * torch.arange(3.0))
    shapes = tree_map(lambda t: tuple(t.shape), a)
    assert shapes == ({"w": (2,)}, {"x": (3,), "y": (1,)})


def test_trainer_runs_on_cpu(tmp_path):
    """examples/ks_torch.py end to end on the CPU: one epoch, finite val."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "ks_torch.py"),
         "--device", "cpu", "--max_epochs", "1", "--data_size", "80",
         "--batch_size", "16", "--train_dir", str(tmp_path),
         # the main path, the trainer's defaults before slice 4(b)
         "--pnode_model", "imex", "--linear_solver", "hpddm",
         "--fixed_jacobian"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("Epoch")][-1]
    val = float(line.split("Val")[1].split("|")[0])
    assert np.isfinite(val), out.stdout


def _pallas_kernel_bodies():
    """{pallas_call site: kernel body} for every ``pallas_call(`` under
    pnode_tpu/ and tools/, each as "path:line": the body is the function
    the call's first argument names, directly, through
    ``functools.partial``, or through a name assigned one of those in the
    enclosing function."""
    def body_name(node, scope):
        if isinstance(node, ast.Call):  # functools.partial(f, ...)
            return body_name(node.args[0], scope)
        if isinstance(node, ast.Name):
            for stmt in ast.walk(scope):
                if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and stmt.targets[0].id == node.id):
                    return body_name(stmt.value, scope)
            return node.id
        raise AssertionError(f"unresolved kernel argument {ast.dump(node)}")

    sites = {}
    roots = [os.path.join(REPO, "pnode_tpu"), os.path.join(REPO, "tools")]
    for root in roots:
        for dirpath, _, names in os.walk(root):
            for n in sorted(names):
                if not n.endswith(".py"):
                    continue
                path = os.path.join(dirpath, n)
                rel = os.path.relpath(path, REPO)
                tree = ast.parse(open(path).read())
                defs = {}
                for node in ast.walk(tree):
                    if isinstance(node, ast.FunctionDef):
                        defs.setdefault(node.name, []).append(node)
                for fn in [f for fs in defs.values() for f in fs]:
                    for node in ast.walk(fn):
                        if (isinstance(node, ast.Call)
                                and isinstance(node.func, ast.Attribute)
                                and node.func.attr == "pallas_call"):
                            name = body_name(node.args[0], fn)
                            lines = [d.lineno for d in defs[name]
                                     if d is not fn]
                            assert len(lines) == 1, (rel, name, lines)
                            sites[f"{rel}:{node.lineno}"] = \
                                f"{rel}:{lines[0]}"
    return sites


def test_every_pallas_call_has_a_ported_kernel():
    """Every TPU kernel (each pallas_call site's body) has an entry in
    chip_smoke.py's KERNELS whose ``replaces`` names it: the kernel table
    cannot fall behind the JAX package."""
    sys.path.insert(0, REPO)
    import chip_smoke

    sites = _pallas_kernel_bodies()
    assert len(sites) == 14, sites
    replaced = {entry[2] for entry in chip_smoke.KERNELS.values()}
    missing = {site: body for site, body in sites.items()
               if body not in replaced}
    assert not missing, missing
    assert replaced <= set(sites.values()), replaced - set(sites.values())
