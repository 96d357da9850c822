"""2-D toy densities for flow training/visualization.

A copy of ``pnode_tpu/ffjord/toy_data.py`` (numpy only; the port cannot
import the JAX package), pinned to it by ``tests/test_torch_ffjord.py``.
Rebuild of the reference's ffjord-pnode ``lib/toy_data.py``: the standard toy
distribution sampler (8gaussians, pinwheel, 2spirals, checkerboard, rings,
moons, swissroll, circles, line, cos) implemented from scratch in numpy.
"""

from __future__ import annotations

import numpy as np


def inf_train_gen(data: str, rng=None, batch_size: int = 200) -> np.ndarray:
    if rng is None:
        rng = np.random.default_rng()

    if data == "8gaussians":
        scale = 4.0
        sq2 = 1.0 / np.sqrt(2)
        centers = np.array(
            [(1, 0), (-1, 0), (0, 1), (0, -1),
             (sq2, sq2), (sq2, -sq2), (-sq2, sq2), (-sq2, -sq2)]
        ) * scale
        idx = rng.integers(0, 8, batch_size)
        pts = rng.normal(scale=0.5, size=(batch_size, 2)) + centers[idx]
        return (pts / 1.414).astype(np.float32)

    if data == "pinwheel":
        radial_std, tangential_std = 0.3, 0.1
        num_classes, rate = 5, 0.25
        rads = np.linspace(0, 2 * np.pi, num_classes, endpoint=False)
        feats = rng.normal(size=(batch_size, 2)) * np.array(
            [radial_std, tangential_std]
        )
        feats[:, 0] += 1.0
        labels = rng.integers(0, num_classes, batch_size)
        angles = rads[labels] + rate * np.exp(feats[:, 0])
        rot = np.stack(
            [np.cos(angles), -np.sin(angles), np.sin(angles), np.cos(angles)],
            axis=-1,
        ).reshape(-1, 2, 2)
        return (2 * np.einsum("ni,nij->nj", feats, rot)).astype(np.float32)

    if data == "2spirals":
        n = np.sqrt(rng.random((batch_size // 2, 1))) * 540 * (2 * np.pi) / 360
        d1x = -np.cos(n) * n + rng.random((batch_size // 2, 1)) * 0.5
        d1y = np.sin(n) * n + rng.random((batch_size // 2, 1)) * 0.5
        x = np.concatenate(
            [np.hstack([d1x, d1y]), np.hstack([-d1x, -d1y])], axis=0
        ) / 3
        x += rng.normal(scale=0.1, size=x.shape)
        return x.astype(np.float32)

    if data == "checkerboard":
        x1 = rng.random(batch_size) * 4 - 2
        x2_ = rng.random(batch_size) - rng.integers(0, 2, batch_size) * 2
        x2 = x2_ + np.floor(x1) % 2
        return (np.stack([x1, x2], 1) * 2).astype(np.float32)

    if data == "rings":
        # Four concentric rings (radii 1.0/0.75/0.5/0.25, scaled by 3):
        # deterministic equispaced angles per ring, then global shuffle + noise.
        radii = (1.0, 0.75, 0.5, 0.25)
        counts = [batch_size // 4] * 3
        counts.append(batch_size - sum(counts))  # innermost absorbs remainder
        pts = []
        for r, cnt in zip(radii, counts):
            ang = np.linspace(0, 2 * np.pi, cnt, endpoint=False)
            pts.append(np.stack([np.cos(ang), np.sin(ang)], axis=1) * r)
        x = np.concatenate(pts, axis=0) * 3.0
        x = x[rng.permutation(batch_size)]
        return (x + rng.normal(scale=0.08, size=x.shape)).astype(np.float32)

    if data == "moons":
        n_out = batch_size // 2
        n_in = batch_size - n_out
        outer_t = np.pi * rng.random(n_out)
        inner_t = np.pi * rng.random(n_in)
        outer = np.stack([np.cos(outer_t), np.sin(outer_t)], 1)
        inner = np.stack([1 - np.cos(inner_t), 1 - np.sin(inner_t) - 0.5], 1)
        x = np.concatenate([outer, inner], 0) * 3 - np.array([1.5, 1.0])
        return (x + rng.normal(scale=0.08, size=x.shape)).astype(np.float32)

    if data == "swissroll":
        t = 1.5 * np.pi * (1 + 2 * rng.random(batch_size))
        x = np.stack([t * np.cos(t), t * np.sin(t)], 1)
        x += rng.normal(scale=0.25, size=x.shape)
        return (x / 5.0).astype(np.float32)

    if data == "circles":
        t = 2 * np.pi * rng.random(batch_size)
        r = np.where(rng.random(batch_size) < 0.5, 1.0, 0.5)
        x = np.stack([r * np.cos(t), r * np.sin(t)], 1) * 3
        return (x + rng.normal(scale=0.08, size=x.shape)).astype(np.float32)

    if data == "line":
        x = rng.random(batch_size) * 5 - 2.5
        return np.stack([x, x + rng.normal(scale=0.1, size=batch_size)], 1).astype(
            np.float32
        )

    if data == "cos":
        x = rng.random(batch_size) * 5 - 2.5
        return np.stack(
            [x, np.sin(x * 3) + rng.normal(scale=0.1, size=batch_size)], 1
        ).astype(np.float32)

    raise ValueError(f"unknown toy dataset {data!r}")
