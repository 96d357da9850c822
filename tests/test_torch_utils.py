"""The port's utils (pnode_tpu_torch/utils), data loader and
petsc_adjoint against the JAX package's: twins of tests/test_utils.py, and
examples/ks_torch.py --hotstart on the CPU."""

import importlib.util
import json
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pnode_tpu
import pnode_tpu_torch as pt
from pnode_tpu.data import WindowedLoader as JWindowedLoader
from pnode_tpu.data import native_available
from pnode_tpu.utils import save_checkpoint as jsave_checkpoint
from pnode_tpu_torch.adjoint import SolveStats
from pnode_tpu_torch.data import WindowedLoader
from pnode_tpu_torch.utils import (
    MetricsWriter, Recorder, RunningAverageMeter, SolverDivergedError, Tee,
    annotate, assert_converged, device_memory_gb, get_logger,
    load_checkpoint, nan_guard, save_checkpoint, trace)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_metrics_writer_jsonl(tmp_path):
    w = MetricsWriter(str(tmp_path), use_tensorboard=False)
    w.add_scalar("Train/Loss", 0.5, 1)
    w.add_scalar("Train/Loss", 0.25, 2)
    w.close()
    lines = (tmp_path / "metrics.jsonl").read_text().strip().splitlines()
    recs = [json.loads(x) for x in lines]
    assert recs[1]["value"] == 0.25 and recs[1]["step"] == 2
    assert recs[0]["tag"] == "Train/Loss" and recs[0]["value"] == 0.5


def test_running_average_meter():
    m = RunningAverageMeter(momentum=0.5)
    m.update(2.0)
    assert m.avg == 2.0
    m.update(4.0)
    assert m.avg == pytest.approx(3.0)


def test_tee_duplicates_stdout(tmp_path):
    f = tmp_path / "log.txt"
    tee = Tee(str(f))
    sys.stdout = tee
    try:
        print("hello-tee")
    finally:
        tee.close()
    assert "hello-tee" in f.read_text()
    assert sys.stdout is tee.stdout


def test_get_logger_file_and_console(tmp_path):
    path = tmp_path / "sub" / "run.log"
    log = get_logger(str(path), name="pnode_tpu_torch_test")
    log.info("hello-logger")
    for h in log.handlers:
        h.flush()
    assert "hello-logger" in path.read_text()
    assert len(log.handlers) == 2


def test_recorder_csv_roundtrip(tmp_path):
    """Twin of test_recorder_csv_roundtrip: the port's CSV equals the JAX
    package's byte for byte, and a second save appends without a
    header."""
    from pnode_tpu.utils import Recorder as JRecorder

    paths = []
    for cls, name in ((Recorder, "port.csv"), (JRecorder, "jax.csv")):
        rec = cls()
        rec.record(a=1, b="x")
        rec.next_record()
        rec.record(a=2, c=3.5)
        paths.append(tmp_path / name)
        rec.save(str(paths[-1]))
    text = paths[0].read_text()
    assert "a" in text and "x" in text and "3.5" in text
    assert text == paths[1].read_text()
    rec = Recorder()
    rec.record(a=3, b="y")
    rec.save(str(paths[0]))
    assert paths[0].read_text().count("a,b") == 1
    assert paths[0].read_text().strip().endswith("3,y")


def test_nan_guard():
    assert nan_guard(torch.tensor(1.5)) == 1.5
    assert nan_guard(torch.tensor(2.0, dtype=torch.bfloat16)) == 2.0
    with pytest.raises(FloatingPointError):
        nan_guard(torch.tensor(float("nan")))
    with pytest.raises(FloatingPointError):
        nan_guard(float("inf"))


def test_assert_converged_dumps(tmp_path):
    stats = SolveStats(newton_iters=torch.tensor(50),
                       newton_converged=torch.tensor(False))
    pt.init(["p", "-pnode_dump_on_failure", str(tmp_path / "fail")])
    try:
        with pytest.raises(SolverDivergedError, match="dumped"):
            assert_converged(stats, "test", dump={"y": torch.ones(3)})
    finally:
        pt.clear_options()
    dumps = list(tmp_path.glob("fail_*.npz"))
    assert len(dumps) == 1
    assert np.allclose(np.load(dumps[0])["y"], 1.0)
    with pytest.raises(SolverDivergedError, match=r"\(test2\)$"):
        assert_converged(stats, "test2")  # no prefix set: no dump


def test_assert_converged_passes():
    stats = SolveStats(newton_iters=torch.tensor(3),
                       newton_converged=torch.tensor(True))
    assert_converged(stats)


def test_device_memory_stats_shape():
    out = device_memory_gb()
    assert set(out) == {"peak_gb", "live_gb"}
    assert device_memory_gb("cpu") == {"peak_gb": 0.0, "live_gb": 0.0}


def test_trace_and_annotate(tmp_path):
    """trace(logdir) writes a Chrome trace holding annotate's span; without
    a logdir or -pnode_profile the block runs untraced."""
    with trace(str(tmp_path)) as prof:
        with annotate("pnode-span"):
            torch.ones(8).sum()
    assert prof is not None
    assert "pnode-span" in (tmp_path / "trace.json").read_text()
    with trace() as prof:
        assert prof is None


def test_roofline_peaks_by_operand_dtype():
    """The H100's peaks by the operands' type (NVIDIA's data sheet, dense):
    fp32 outside the tensor cores 67 TFLOP/s, bf16 on them 989, one
    memory rate of 3.35 TB/s; a dtype without a peak raises."""
    from pnode_tpu_torch.utils.roofline import H100_PEAKS, peaks_for

    assert peaks_for(H100_PEAKS) == (67e12, 3.35e12)
    assert peaks_for(H100_PEAKS, torch.bfloat16) == (989e12, 3.35e12)
    with pytest.raises(ValueError):
        peaks_for(H100_PEAKS, torch.float16)


def test_roofline_without_a_card():
    from pnode_tpu_torch.utils import roofline

    out = roofline.roofline(1e9, 1e6, 10.0)
    assert out["flops_per_unit"] == 1e9 and out["mfu"] is None
    if not torch.cuda.is_available():
        assert roofline.device_peaks() is None


@pytest.mark.parametrize("endpoint", [False, True], ids=["window",
                                                          "endpoint"])
@pytest.mark.parametrize("use_native", [None, False],
                         ids=["native", "numpy"])
def test_windowed_loader_matches_jax(use_native, endpoint):
    """The port's WindowedLoader yields the JAX loader's batches bit for
    bit over two epochs: natively (the shared csrc/windowed_loader.cpp,
    mt19937_64 + std::shuffle) and in the numpy order; targets are the
    window after each start."""
    if use_native is None and not native_available():
        pytest.skip("the JAX package's native loader library is absent")
    u = np.random.default_rng(0).normal(size=(103, 5))
    ours = WindowedLoader(u, window=3, batch=7, seed=4,
                          endpoint_only=endpoint, use_native=use_native)
    ref = JWindowedLoader(u, window=3, batch=7, seed=4,
                          endpoint_only=endpoint, use_native=use_native)
    assert ours.native == (use_native is None) == ref.native
    assert ours.batches_per_epoch == ref.batches_per_epoch == 14
    u32 = u.astype(np.float32)
    for epoch in range(2):
        n = 0
        for (y0, tgt), (jy0, jtgt) in zip(ours, ref):
            assert y0.dtype == np.float32
            np.testing.assert_array_equal(y0, jy0)
            np.testing.assert_array_equal(tgt, jtgt)
            i = np.array([int(np.nonzero((u32 == row).all(1))[0][0])
                          for row in y0])
            want = (u32[i + 3][:, None] if endpoint else
                    np.stack([u32[i + 1 + j] for j in range(3)], 1))
            np.testing.assert_array_equal(tgt, want)
            n += 1
        assert n == 14
    ours.close()


def test_windowed_loader_epochs_differ_and_native_builds():
    """Each epoch reshuffles; the native library is the port's own build
    under build/pnode_tpu_torch, not the JAX package's."""
    from pnode_tpu_torch import native

    u = np.arange(60, dtype=np.float32).reshape(30, 2)
    ld = WindowedLoader(u, window=3, batch=5, seed=0)
    first = [y0.copy() for y0, _ in ld]
    second = [y0.copy() for y0, _ in ld]
    assert len(first) == len(second) == 5
    assert not all(np.array_equal(a, b) for a, b in zip(first, second))
    path = native.build("windowed_loader")
    assert path.parent == native.BUILD_DIR
    assert "-pthread" in native.EXTRA_FLAGS["windowed_loader"]


def test_checkpoint_roundtrip_and_jax_files(tmp_path):
    """A tensor tree with metadata round-trips as numpy (bf16 as fp32); a
    file the JAX package's save_checkpoint wrote reads here, and one
    written here reads with the JAX package's load_checkpoint; orbax is
    refused, by argument and by -pnode_checkpoint_format."""
    from pnode_tpu.utils import load_checkpoint as jload_checkpoint

    payload = {"epoch": 7, "best": 0.125, "normalize": None,
               "params": {"w": torch.arange(6.0).reshape(2, 3),
                          "b": torch.ones(3, dtype=torch.bfloat16)},
               "list": [torch.zeros(2), 3]}
    p1 = str(tmp_path / "ck.ckpt")
    save_checkpoint(p1, payload)
    r1 = load_checkpoint(p1)
    assert r1["epoch"] == 7 and r1["normalize"] is None
    np.testing.assert_array_equal(r1["params"]["w"],
                                  np.arange(6.0).reshape(2, 3))
    assert r1["params"]["b"].dtype == np.float32
    assert isinstance(r1["list"], list) and r1["list"][1] == 3
    r1j = jload_checkpoint(p1, format="pickle")
    np.testing.assert_array_equal(r1j["params"]["w"], r1["params"]["w"])
    p2 = str(tmp_path / "jax.ckpt")
    jsave_checkpoint(p2, {"epoch": 3, "params": {
        "w": jnp.arange(4.0), "b": jnp.ones(2)}}, format="pickle")
    r2 = load_checkpoint(p2)
    assert r2["epoch"] == 3
    np.testing.assert_array_equal(r2["params"]["w"], np.arange(4.0))
    with open(p2, "rb") as f:
        assert pickle.load(f)["epoch"] == 3
    with pytest.raises(ValueError, match="pickle only"):
        save_checkpoint(str(tmp_path / "o"), payload, format="orbax")
    pt.init(["p", "-pnode_checkpoint_format", "orbax"])
    try:
        with pytest.raises(ValueError, match="pickle only"):
            load_checkpoint(p1)
    finally:
        pt.clear_options()


def test_petsc_adjoint_alias():
    """pnode_tpu_torch.petsc_adjoint.ODEPetsc is ODESolver, as in the JAX
    package, and solves."""
    from pnode_tpu import petsc_adjoint as jpa
    from pnode_tpu_torch import petsc_adjoint

    assert petsc_adjoint.ODEPetsc is pt.ODESolver
    assert jpa.ODEPetsc is pnode_tpu.ODESolver
    ode = petsc_adjoint.ODEPetsc()
    ode.setupTS(torch.zeros(2, dtype=torch.float64),
                pt.Func(lambda t, y, p: -y), step_size=0.1, method="rk4")
    sol = ode.odeint(torch.ones(2, dtype=torch.float64),
                     np.array([0.0, 1.0]))
    np.testing.assert_allclose(sol[-1].numpy(), np.exp(-1.0), rtol=1e-5)


def _ks_torch():
    spec = importlib.util.spec_from_file_location(
        "ks_torch", os.path.join(REPO, "examples", "ks_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ks_torch_hotstart(tmp_path, capsys):
    """examples/ks_torch.py on the main path's flags: one epoch writes
    best_imex.ckpt (epoch, params, best_val, normalize), --hotstart
    resumes at epoch 1 with the checkpoint's weights and best validation
    loss, and a checkpoint of another normalization is refused; its first
    epoch trains on the JAX loader's native batches."""
    ks = _ks_torch()
    argv = ["--device", "cpu", "--data_size", "80", "--batch_size", "16",
            "--train_dir", str(tmp_path), "--pnode_model", "imex",
            "--linear_solver", "hpddm", "--fixed_jacobian"]
    best, hist = ks.main(argv + ["--max_epochs", "1"])
    pt.clear_options()
    ck = load_checkpoint(str(tmp_path / "best_imex.ckpt"))
    assert ck["epoch"] == 0 and ck["best_val"] == best
    assert ck["normalize"] is None and len(hist) == 1 and len(hist[0]) == 3
    assert set(ck["params"]) >= {"net.kernel_0", "net.bias_0"}
    best2, hist2 = ks.main(argv + ["--max_epochs", "2", "--hotstart"])
    pt.clear_options()
    out = capsys.readouterr().out
    assert f"hotstart from epoch 1 (best val {best:.6e})" in out
    assert "Epoch 0001" in out and len(hist2) == 1
    assert best2 <= best
    with pytest.raises(RuntimeError, match="normalization mismatch"):
        ks.main(argv + ["--max_epochs", "3", "--hotstart", "--normalize",
                        "mean"])
    pt.clear_options()
