"""The PyTorch port's scaffold against the JAX package: import hygiene, and
the numpy-only modules the port carries as copies (tableaus, time grid,
KS data, options database) pinned to their originals."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu.data.spectral as jax_spectral
import pnode_tpu.grid as jax_grid
import pnode_tpu.options as jax_options
import pnode_tpu.tableaus as jax_tableaus
import pnode_tpu_torch
import pnode_tpu_torch.data.spectral as pt_spectral
import pnode_tpu_torch.grid as pt_grid
import pnode_tpu_torch.options as pt_options
import pnode_tpu_torch.tableaus as pt_tableaus
from pnode_tpu_torch.misc import tree_add, tree_leaves, tree_map, tree_zeros_like

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_torch_options():
    pnode_tpu_torch.clear_options()
    yield
    pnode_tpu_torch.clear_options()


def test_import_leaves_jax_out():
    """Importing the port (every module, the trainer and chip_smoke) pulls
    in none of jax, flax, optax or pnode_tpu."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import pnode_tpu_torch, pnode_tpu_torch.solver, "
        "pnode_tpu_torch.convert, pnode_tpu_torch.models, "
        "pnode_tpu_torch.data, pnode_tpu_torch.ops.fused_mlp, "
        "pnode_tpu_torch.ops.fused_ark_forward, "
        "pnode_tpu_torch.ops.fused_ark_adjoint, pnode_tpu_torch.ops._build, "
        "pnode_tpu_torch.ops.fused_train_loop, "
        "pnode_tpu_torch.ops.fused_adaptive_loop, pnode_tpu_torch.adaptive, "
        "pnode_tpu_torch.tableaus_ark5, pnode_tpu_torch.tableaus_ark5l\n"
        "import chip_smoke\n"
        "import importlib.util as u\n"
        "s = u.spec_from_file_location('ks_torch', %r)\n"
        "m = u.module_from_spec(s); s.loader.exec_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'pnode_tpu'))\n"
        "print('BAD', bad)\n"
    ) % (REPO, os.path.join(REPO, "examples", "ks_torch.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_sources_name_no_jax_package():
    """No source of the port, nor the trainer or chip_smoke, imports jax,
    flax, optax or pnode_tpu (the package, not pnode_tpu_torch)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|pnode_tpu)"
                     r"(\s|\.|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "examples", "ks_torch.py")]
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
         "--batch_size", "16", "--train_dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("Epoch")][-1]
    val = float(line.split("Val")[1].split("|")[0])
    assert np.isfinite(val), out.stdout
