"""MAF tabular density-estimation datasets (POWER/GAS/HEPMASS/MINIBOONE/BSDS300).

A copy of ``pnode_tpu/ffjord/datasets.py`` (numpy only; the port cannot
import the JAX package), pinned to it by ``tests/test_torch_ffjord.py``.
Rebuild of the reference's ffjord-pnode ``datasets/``: the loaders expect the
standard MAF preprocessed files under ``<root>/`` (power/data.npy,
gas/ethylene_CO.pickle, hepmass/*.csv, miniboone/data.npy,
BSDS300/BSDS300.hdf5). This environment has no network egress, so when the
files are absent a deterministic synthetic surrogate with the right
dimensionality is generated instead (flagged in the returned metadata) so
the full training pipeline stays runnable end-to-end.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

DATA_DIMS = {
    "power": 6,
    "gas": 8,
    "hepmass": 21,
    "miniboone": 43,
    "bsds300": 63,
}


@dataclass
class TabularData:
    name: str
    trn: np.ndarray
    val: np.ndarray
    tst: np.ndarray
    synthetic: bool

    @property
    def dim(self) -> int:
        return self.trn.shape[1]


def _synthetic(name: str, seed: int = 0) -> TabularData:
    """Correlated gaussian-mixture surrogate with the dataset's true dim."""
    dim = DATA_DIMS[name]
    rng = np.random.default_rng(seed)
    n = 40000
    k = 4
    means = rng.normal(scale=2.0, size=(k, dim))
    data = []
    for _ in range(k):
        A = rng.normal(scale=0.4, size=(dim, dim))
        cov_chol = np.eye(dim) * 0.6 + 0.2 * A
        data.append(rng.normal(size=(n // k, dim)) @ cov_chol.T)
    x = np.concatenate([d + m for d, m in zip(data, means)], axis=0)
    rng.shuffle(x)
    x = (x - x.mean(0)) / x.std(0)
    n_trn, n_val = int(0.8 * len(x)), int(0.1 * len(x))
    return TabularData(
        name,
        x[:n_trn].astype(np.float32),
        x[n_trn:n_trn + n_val].astype(np.float32),
        x[n_trn + n_val:].astype(np.float32),
        synthetic=True,
    )


def _normalize_splits(trn, val, tst):
    mu, s = trn.mean(0), trn.std(0)
    return tuple(((a - mu) / s).astype(np.float32) for a in (trn, val, tst))


def _load_power(root):
    # MAF preprocessing (datasets/power.py): noise-injected, drop cols 1,3
    rng = np.random.default_rng(42)
    data = np.load(os.path.join(root, "power", "data.npy"))
    rng.shuffle(data)
    n = data.shape[0]
    data = np.delete(data, [1, 3], axis=1)
    voltage_noise = 0.01 * rng.random((n, 1))
    gap_noise = 0.001 * rng.random((n, 1))
    sm_noise = rng.random((n, 3))
    time_noise = np.zeros((n, 1))
    data = data + np.hstack([gap_noise, voltage_noise, sm_noise, time_noise])
    n_test = int(0.1 * n)
    tst = data[-n_test:]
    data = data[:-n_test]
    n_val = int(0.1 * data.shape[0])
    val, trn = data[-n_val:], data[:-n_val]
    return _normalize_splits(trn, val, tst)


def _load_miniboone(root):
    data = np.load(os.path.join(root, "miniboone", "data.npy"))
    n_test = int(0.1 * data.shape[0])
    tst = data[-n_test:]
    data = data[:-n_test]
    n_val = int(0.1 * data.shape[0])
    val, trn = data[-n_val:], data[:-n_val]
    return _normalize_splits(trn, val, tst)


def _load_gas(root):
    """GAS preprocessing (datasets/gas.py): drop Meth/Eth/Time, iteratively
    remove columns correlated > 0.98 with more than one other, whole-data
    z-score, then 10%/10% tail splits."""
    import pandas as pd

    data = pd.read_pickle(os.path.join(root, "gas", "ethylene_CO.pickle"))
    for col in ("Meth", "Eth", "Time"):
        data = data.drop(col, axis=1)

    def corr_counts(d):
        return (d.corr() > 0.98).values.sum(axis=1)

    B = corr_counts(data)
    while np.any(B > 1):
        col = data.columns[int(np.where(B > 1)[0][0])]
        data = data.drop(col, axis=1)
        B = corr_counts(data)
    data = (data - data.mean()) / data.std()
    arr = data.values
    n_test = int(0.1 * arr.shape[0])
    tst, rest = arr[-n_test:], arr[:-n_test]
    n_val = int(0.1 * rest.shape[0])
    val, trn = rest[-n_val:], rest[:-n_val]
    return tuple(a.astype(np.float32) for a in (trn, val, tst))


def _load_hepmass(root):
    """HEPMASS preprocessing (datasets/hepmass.py): keep class-1 rows, drop
    the label column (and the test set's stray trailing column), z-score by
    TRAIN stats, then drop features whose most-frequent... — faithfully, the
    reference checks the count of the SMALLEST value per feature (a known
    MAF quirk, reproduced as-is) and removes features where it exceeds 5;
    finally a 10% validation tail split."""
    import pandas as pd
    from collections import Counter

    tr = pd.read_csv(os.path.join(root, "hepmass", "1000_train.csv"),
                     index_col=False)
    te = pd.read_csv(os.path.join(root, "hepmass", "1000_test.csv"),
                     index_col=False)
    tr = tr[tr[tr.columns[0]] == 1].drop(tr.columns[0], axis=1)
    te = te[te[te.columns[0]] == 1].drop(te.columns[0], axis=1)
    te = te.drop(te.columns[-1], axis=1)  # the published test file is off
    mu, s = tr.mean(), tr.std()
    tr = ((tr - mu) / s).to_numpy()
    te = ((te - mu) / s).to_numpy()
    drop = []
    for i, feature in enumerate(tr.T):
        c = Counter(feature)
        first_count = np.array([v for _, v in sorted(c.items())])[0]
        if first_count > 5:
            drop.append(i)
    keep = [i for i in range(tr.shape[1]) if i not in drop]
    tr, te = tr[:, keep], te[:, keep]
    n_val = int(0.1 * tr.shape[0])
    val, trn = tr[-n_val:], tr[:-n_val]
    return tuple(a.astype(np.float32) for a in (trn, val, te))


def _load_bsds300(root):
    """BSDS300 patches (datasets/bsds300.py): h5 train/validation/test
    groups used verbatim (no normalization)."""
    import h5py

    path = os.path.join(root, "BSDS300", "BSDS300.hdf5")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with h5py.File(path, "r") as f:
        trn = np.asarray(f["train"])
        val = np.asarray(f["validation"])
        tst = np.asarray(f["test"])
    return tuple(a.astype(np.float32) for a in (trn, val, tst))


_LOADERS = {
    "power": _load_power,
    "gas": _load_gas,
    "hepmass": _load_hepmass,
    "miniboone": _load_miniboone,
    "bsds300": _load_bsds300,
}


def load_tabular(name: str, root: str = "data") -> TabularData:
    name = name.lower()
    if name not in DATA_DIMS:
        raise ValueError(f"unknown dataset {name!r}; options {sorted(DATA_DIMS)}")
    try:
        trn, val, tst = _LOADERS[name](root)
        return TabularData(name, trn, val, tst, synthetic=False)
    except (FileNotFoundError, OSError, ImportError, KeyError):
        return _synthetic(name)
