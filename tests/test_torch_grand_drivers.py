"""The GRAND drivers of the port on the CPU, and their pieces against the
JAX drivers'.

- examples/grand_node_torch.py: ``main`` for 2 epochs at the default,
  transformer/imex, hard_att, ``--rewire_knn``, ``--early_stop_int`` and
  ``--beltrami``; its optimizer against ``optax.adamw`` and its masked CE
  against optax's, at rtol 1e-12 in fp64.
- examples/grand_image_torch.py: one epoch on the surrogate; its surrogate
  and IDX reader against examples/grand_image.py's (imported as a module,
  its flags in ``sys.argv``).
- examples/grand_sweep_torch.py: one random trial, and an ASHA sweep of
  two trials over two rungs.
"""

import csv
import gzip
import importlib.util
import os
import struct
import sys

import numpy as np
import optax
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_options():
    pt.clear_options()
    pnode_tpu.clear_options()
    yield
    pt.clear_options()
    pnode_tpu.clear_options()


def _load(name, argv=None):
    """examples/<name>.py as a module; a JAX driver parses ``argv`` at
    import, so it goes into sys.argv for the import."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    saved = sys.argv
    sys.argv = [f"{name}.py"] + list(argv or [])
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    pnode_tpu.clear_options()
    return mod


def _csv_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("flags", [
    [],
    ["--function", "transformer", "--block", "imex"],
    ["--block", "hard_att", "--att_samp_pct", "0.7"],
    ["--rewire_knn", "1", "--knn_k", "8"],
    ["--early_stop_int"],
    ["--beltrami", "--pos_enc_dim", "8", "--pos_enc_hidden", "8"],
], ids=["default", "imex", "hard_att", "rewire_knn", "early_stop_int",
        "beltrami"])
def test_node_driver_runs_on_cpu(tmp_path, capsys, flags):
    gn = _load("grand_node_torch")
    out = gn.main(["--device", "cpu", "--epochs", "2", "--train_dir",
                   str(tmp_path)] + flags)
    assert out["epochs"] == 2 and np.all(np.isfinite(out["losses"]))
    assert 0.0 <= out["best_test"] <= 1.0 and out["best_val"] > 0
    rows = _csv_rows(tmp_path / "results.csv")
    assert rows[-1]["block"] == (flags[flags.index("--block") + 1]
                                 if "--block" in flags else "pnode")
    printed = capsys.readouterr().out
    assert "Epoch 000 |" in printed and "best val" in printed
    if "--rewire_knn" in flags:
        assert "kNN rewiring (T0, k=8): 3200 edges" in printed


def test_node_driver_optimizer_and_loss_match_optax():
    """make_optimizer is optax.adamw (decoupled decay, eps 1e-8) and
    masked_ce optax's masked mean, over three steps in fp64."""
    gn = _load("grand_node_torch")
    args, _ = gn.parse_args(["--device", "cpu"])
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3))
    grads = [rng.normal(size=(5, 3)) for _ in range(3)]
    opt = optax.adamw(args.lr, weight_decay=args.decay)
    p, s = w0, opt.init(w0)
    mod = torch.nn.Linear(3, 5, bias=False).double()
    with torch.no_grad():
        mod.weight.copy_(torch.as_tensor(w0))
    topt = gn.make_optimizer(mod, args)
    for g in grads:
        u, s = opt.update(g, s, params=p)
        p = optax.apply_updates(p, u)
        mod.weight.grad = torch.as_tensor(g)
        topt.step()
        np.testing.assert_allclose(mod.weight.detach().numpy(), p,
                                   rtol=1e-12, atol=0)
    logits, y = rng.normal(size=(7, 4)), rng.integers(0, 4, 7)
    mask = rng.random(7) < 0.5
    ref = np.sum(optax.softmax_cross_entropy_with_integer_labels(
        logits, y) * mask) / np.sum(mask)
    got = gn.masked_ce(torch.as_tensor(logits), torch.as_tensor(y),
                       torch.as_tensor(mask, dtype=torch.float64))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)


def test_image_driver_runs_on_cpu(capsys):
    gi = _load("grand_image_torch")
    out = gi.main(["--device", "cpu", "--epochs", "1", "--train_size",
                   "512"])
    assert out["iters"] == 2 and np.all(np.isfinite(out["losses"]))
    assert 0.0 <= out["test_acc"][0] <= 1.0 and out["images_per_s"] > 0
    printed = capsys.readouterr().out
    assert "quadrant-blob surrogate" in printed and "epoch 000" in printed


def test_image_driver_data_match_jax(tmp_path):
    """The surrogate (the same numpy draws) and the IDX reader on files
    in the real format, gzipped and not."""
    gi = _load("grand_image_torch")
    jd = _load("grand_image", ["--cpu"])
    for args in ((64, 16, 16, 4, 0), (10, 12, 8, 4, 3)):
        for a, b in zip(jd.synthetic(*args), gi.synthetic(*args)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (7, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 7).astype(np.uint8)
    files = {"train-images-idx3-ubyte.gz": (0x803, imgs),
             "t10k-images-idx3-ubyte": (0x803, imgs[:3]),
             "train-labels-idx1-ubyte": (0x801, labels),
             "t10k-labels-idx1-ubyte.gz": (0x801, labels[:3])}
    for name, (magic, arr) in files.items():
        raw = struct.pack(f">I{arr.ndim}I", magic, *arr.shape) + \
            arr.tobytes()
        op = gzip.open if name.endswith(".gz") else open
        with op(tmp_path / name, "wb") as f:
            f.write(raw)
    for a, b in zip(jd.load_mnist(str(tmp_path)),
                    gi.load_mnist(str(tmp_path))):
        np.testing.assert_array_equal(a, b)
    args, _ = gi.parse_args(["--data_dir", str(tmp_path), "--train_size",
                             "5"])
    x_tr, y_tr, x_te, _, n_cls, syn = gi.load_data(args)
    assert x_tr.shape == (5, 28, 28, 1) and n_cls == 10 and not syn


def test_sweep_runs_trials_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each trial's process
    sw = _load("grand_sweep_torch")
    out = sw.main(["--device", "cpu", "--scheduler", "random", "--trials",
                   "1", "--epochs", "2", "--train_dir", str(tmp_path)])
    (cfg, epochs, val), = out["trials"]
    assert epochs == 2 and 0.0 < val <= 1.0
    assert len(_csv_rows(tmp_path / "results.csv")) == 1
    out = sw.main(["--device", "cpu", "--trials", "2", "--epochs", "2",
                   "--train_dir", str(tmp_path)])
    assert [e for _, e, _ in out["trials"]] == [1, 1, 2]
    assert all(v > 0 for _, _, v in out["trials"])
    assert out["best"][0] == out["trials"][-1][2]
    assert len(_csv_rows(tmp_path / "results.csv")) == 4
    assert "promoted 1/2" in capsys.readouterr().out
