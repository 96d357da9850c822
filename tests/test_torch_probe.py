"""The shared-memory probe (pnode_tpu_torch.tools.probe_smem_limit, K13)
against tools/probe_vmem_limit.py: its plain version, its OK / WRONG RESULT
/ FAIL reporting and its search order, with stub launchers in place of the
card (K13 itself runs in chip_smoke.py phase 2)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from pnode_tpu_torch.tools import probe_smem_limit as probe

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stub(limit, wrong=()):
    """A launcher that fails above ``limit`` bytes (as a launch over the
    card's opt-in does) and answers wrongly at the sizes in ``wrong``;
    it records the sizes it was asked for."""
    def launch(x, nbytes):
        launch.sizes.append(nbytes)
        if nbytes > limit:
            raise RuntimeError(f"probe_smem at {nbytes} B failed: CUDA error "
                               "1 (invalid argument)\nmore")
        return probe.probe_smem_plain(x) + (1.0 if nbytes in wrong else 0.0)

    launch.sizes = []
    return launch


def test_plain_version_is_two_x_plus_x():
    x = probe.probe_input(1024, "cpu")
    assert x.shape == (4, 128)  # two tiles of 256 floats
    out = probe.probe_smem(x, 1024)
    assert torch.equal(out, 2.0 * x + x) and torch.equal(out, 3.0 * x)
    with pytest.raises(ValueError, match="multiple of 4"):
        probe.probe_smem(x, 1022)
    with pytest.raises(ValueError, match="float32"):
        probe.probe_smem(x.double(), 1024)


def test_try_size_reports_ok_wrong_and_fail(capsys):
    """The reference's three verdicts (tools/probe_vmem_limit.py:51-57): a
    launch that raises is FAIL with the first line of its message; a
    result other than 3x is WRONG RESULT; both return False."""
    assert probe.try_size(4096, "cpu") is True
    assert probe.try_size(4096, "cpu", launch=_stub(4096, wrong=(4096,))) \
        is False
    assert probe.try_size(8192, "cpu", launch=_stub(4096)) is False
    lines = capsys.readouterr().out.splitlines()
    assert lines == [
        "  dynamic smem    4096 B: OK",
        "  dynamic smem    4096 B: WRONG RESULT",
        "  dynamic smem    8192 B: FAIL (probe_smem at 8192 B failed: CUDA "
        "error 1 (invalid argument))"]


@pytest.mark.parametrize("limit", [232448, 100000, 49152, 40000, 300000])
def test_search_finds_the_limit(limit, capsys):
    """Up the ladder to the first size that fails, then bisection to 4
    bytes: the largest working size is the limit (rounded down to 4), the
    smallest failing one 4 bytes above it; no size past the first failing
    rung is ever tried. A card that never fails reports the top rung."""
    launch = _stub(limit)
    lo, hi = probe.search(lambda n: probe.try_size(n, "cpu", launch=launch))
    ladder = [s for s in launch.sizes if s in probe.LADDER]
    first_fail = next((s for s in probe.LADDER if s > limit), None)
    if first_fail is None:
        assert (lo, hi) == (probe.LADDER[-1], None)
        assert launch.sizes == list(probe.LADDER)
        return
    assert (lo, hi) == (limit // 4 * 4, limit // 4 * 4 + 4)
    assert ladder == [s for s in probe.LADDER if s <= first_fail]
    assert max(launch.sizes) == first_fail
    assert all(s % 4 == 0 for s in launch.sizes)
    assert len(capsys.readouterr().out.splitlines()) == len(launch.sizes)


def _reference_probe():
    spec = importlib.util.spec_from_file_location(
        "probe_vmem_limit", os.path.join(REPO, "tools", "probe_vmem_limit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_search_order_matches_the_reference(monkeypatch, capsys):
    """The reference climbs its ladder in order and stops at the first size
    that fails, reporting the last that worked (:67-75). With the failure
    at the same rung of each ladder, both probes try the same rungs in the
    same order; the port then bisects inside the failing step."""
    ref = _reference_probe()
    tried = []

    def ref_try(mb, limit_mb):
        tried.append(mb)
        return mb < 48

    monkeypatch.setattr(ref, "try_size", ref_try)
    monkeypatch.setattr(sys, "argv", ["probe_vmem_limit.py"])
    ref.main()
    assert capsys.readouterr().out.splitlines()[-1] == \
        "largest working resident set: ~32 MB (fails at 48 MB)"
    rung = (12, 16, 24, 32, 48, 64, 96, 120).index(48)
    launch = _stub(probe.LADDER[rung] - 4)
    lo, hi = probe.search(lambda n: probe.try_size(n, "cpu", launch=launch))
    assert launch.sizes[:rung + 1] == list(probe.LADDER[:rung + 1])
    assert len(tried) == rung + 1
    assert probe.LADDER[rung - 1] < lo < hi == probe.LADDER[rung]
    assert np.all(np.diff(launch.sizes[rung:]) != 0)


def test_main_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(SystemExit, match="CUDA"):
        probe.main([])
