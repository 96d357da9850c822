"""Self-contained training-data generators for the SINODE PDE examples.

The reference's Burgers and KS drivers load pre-generated pickle files that
are NOT vendored in its repository
(reference examples-sinode/Burgers/Burgers.py:321 loads
``Data_T5_IC100_NX1024.p``; reference examples-sinode/KS/KS.py:124
loads ``training_data_L22_S64_N10000.pickle``). To make the examples
self-contained, trajectories are generated here with a high-accuracy
spectral exponential integrator (ETDRK4, the standard Kassam & Trefethen
2005 "fourth-order time-stepping for stiff PDEs" scheme, implemented from
scratch in numpy) and cached as .npz:

- KS:      u_t = -u u_x - u_xx - u_xxxx,  periodic on [0, L], L = 22
           (the chaotic regime the KS example trains on; 64-point grid,
           dt matching the reference config runs64_a100.sh).
- Burgers: u_t = -u u_x + nu u_xx, periodic on [0, 1], nu = 8e-4
           (matching BurgersFuncIM's fixed Laplacian alpha = 8e-4; 100
           random ICs, T = 5, saved every 0.1).

A copy of ``pnode_tpu/data/spectral.py`` (which the port cannot import);
``tests/test_torch_scaffold.py`` pins both generators bit-equal to it, and
the cache file names are the same.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _etdrk4_coeffs(L: np.ndarray, dt: float, n_contour: int = 32):
    """ETDRK4 scalar coefficients via complex contour averaging (handles the
    removable singularities at L*dt -> 0)."""
    E = np.exp(dt * L)
    E2 = np.exp(dt * L / 2.0)
    r = np.exp(1j * np.pi * (np.arange(1, n_contour + 1) - 0.5) / n_contour)
    LR = dt * L[:, None] + r[None, :]
    Q = dt * np.real(np.mean((np.exp(LR / 2.0) - 1.0) / LR, axis=1))
    f1 = dt * np.real(
        np.mean((-4.0 - LR + np.exp(LR) * (4.0 - 3.0 * LR + LR**2)) / LR**3, axis=1)
    )
    f2 = dt * np.real(
        np.mean((2.0 + LR + np.exp(LR) * (-2.0 + LR)) / LR**3, axis=1)
    )
    f3 = dt * np.real(
        np.mean((-4.0 - 3.0 * LR - LR**2 + np.exp(LR) * (4.0 - LR)) / LR**3, axis=1)
    )
    return E, E2, Q, f1, f2, f3


def etdrk4_solve(
    u0: np.ndarray,
    lin_symbol: np.ndarray,
    nonlin,
    dt: float,
    n_steps: int,
    save_every: int = 1,
) -> np.ndarray:
    """Integrate u_t = L u + N(u) spectrally with ETDRK4.

    u0: (..., nx) real initial condition(s); lin_symbol: (nx,) Fourier symbol
    of the linear operator; nonlin(v_hat) returns the Fourier transform of
    the nonlinear term given the state's Fourier transform. Returns the
    saved real-space trajectory of shape (n_saved+1, ..., nx).
    """
    E, E2, Q, f1, f2, f3 = _etdrk4_coeffs(lin_symbol, dt)
    v = np.fft.fft(u0, axis=-1)
    out = [np.asarray(u0, dtype=np.float64)]
    for n in range(1, n_steps + 1):
        Nv = nonlin(v)
        a = E2 * v + Q * Nv
        Na = nonlin(a)
        b = E2 * v + Q * Na
        Nb = nonlin(b)
        c = E2 * a + Q * (2.0 * Nb - Nv)
        Nc = nonlin(c)
        v = E * v + Nv * f1 + 2.0 * (Na + Nb) * f2 + Nc * f3
        if n % save_every == 0:
            out.append(np.real(np.fft.ifft(v, axis=-1)))
    return np.stack(out, axis=0)


def generate_ks_data(
    nx: int = 64,
    L: float = 22.0,
    n_samples: int = 10000,
    dt_data: float = 0.2,
    transient: float = 100.0,
    seed: int = 0,
    cache_dir: Optional[str] = None,
) -> Tuple[np.ndarray, float]:
    """Chaotic KS trajectory on the attractor: (n_samples, nx) array + dt.

    Replaces the reference's ``training_data_L22_S64_N10000.pickle``
    (input_sequence of shape (N, dim) with uniform dt).

    The classic dealiased Fourier-Galerkin L=22 truncation has a late-time
    finite-dimensional instability (blow-up near t ~ 370 regardless of dt,
    resolution, or IC — verified independently with an RK4 control at
    dt = 2e-4), so long datasets are produced as INDEPENDENT chunks, each
    well below the blow-up horizon with its own transient. Chunk seams
    introduce at most (n_chunks - 1) unrelated training windows out of
    n_samples — negligible label noise. The result is guaranteed finite.
    """
    cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache = os.path.join(
            cache_dir,
            f"ks_v2_L{L}_nx{nx}_N{n_samples}_dt{dt_data}_s{seed}.npz",
        )
        if os.path.exists(cache):
            d = np.load(cache)
            return d["u"], float(d["dt"])

    k = 2.0 * np.pi * np.fft.fftfreq(nx, d=L / nx)
    lin = k**2 - k**4
    ik = 1j * k
    dealias = np.abs(k) < (2.0 / 3.0) * np.max(np.abs(k))

    def nonlin(v):
        u = np.real(np.fft.ifft(v, axis=-1))
        return -0.5 * ik * (np.fft.fft(u * u, axis=-1) * dealias)

    rng = np.random.default_rng(seed)
    x = np.arange(nx) * L / nx
    dt_inner = 0.05  # inner ETDRK4 step; data saved every dt_data
    save_every = int(round(dt_data / dt_inner))
    n_trans = int(round(transient / dt_inner))
    # stay far below the t~370 instability horizon per chunk
    max_chunk = max(1, int(200.0 / dt_data))

    chunks = []
    remaining = n_samples
    attempt = 0
    while remaining > 0:
        take = min(max_chunk, remaining)
        u0 = (
            0.1 * np.cos(2 * np.pi * x / L) * (1 + np.sin(2 * np.pi * x / L))
            + 0.01 * rng.standard_normal(nx)
        )
        warm = etdrk4_solve(u0, lin, nonlin, dt_inner, n_trans,
                            save_every=n_trans)
        traj = etdrk4_solve(
            warm[-1], lin, nonlin, dt_inner, take * save_every,
            save_every=save_every,
        )
        chunk = traj[1:1 + take]
        if not np.isfinite(chunk).all():
            attempt += 1
            if attempt > 8:
                raise RuntimeError("KS generator failed to stay finite")
            continue
        chunks.append(chunk.astype(np.float64))
        remaining -= take
    u = np.concatenate(chunks, axis=0)
    assert np.isfinite(u).all()
    if cache:
        np.savez_compressed(cache, u=u, dt=dt_data)
    return u, dt_data


def generate_burgers_data(
    nx: int = 512,
    n_ic: int = 100,
    nu: float = 8e-4,
    T: float = 5.0,
    dt_save: float = 0.1,
    seed: int = 0,
    cache_dir: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Viscous Burgers ensemble: (n_ic, n_t, nx) + times, like the
    reference's ``Data_T5_IC100_NX1024.p`` (u, t) payload."""
    cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache = os.path.join(
            cache_dir, f"burgers_nx{nx}_ic{n_ic}_nu{nu}_T{T}_s{seed}.npz"
        )
        if os.path.exists(cache):
            d = np.load(cache)
            return d["u"], d["t"]

    k = 2.0 * np.pi * np.fft.fftfreq(nx, d=1.0 / nx)
    lin = -nu * k**2
    ik = 1j * k
    dealias = np.abs(k) < (2.0 / 3.0) * np.max(np.abs(k))

    def nonlin(v):
        u = np.real(np.fft.ifft(v, axis=-1))
        return -0.5 * ik * (np.fft.fft(u * u, axis=-1) * dealias)

    # smooth random periodic initial conditions (low-mode Fourier series)
    rng = np.random.default_rng(seed)
    x = np.arange(nx) / nx
    n_modes = 4
    u0 = np.zeros((n_ic, nx))
    for m in range(1, n_modes + 1):
        amp_s = rng.standard_normal((n_ic, 1)) / m
        amp_c = rng.standard_normal((n_ic, 1)) / m
        u0 += amp_s * np.sin(2 * np.pi * m * x) + amp_c * np.cos(2 * np.pi * m * x)
    u0 /= np.maximum(np.abs(u0).max(axis=-1, keepdims=True), 1e-12)

    dt_inner = 0.002
    save_every = int(round(dt_save / dt_inner))
    n_steps = int(round(T / dt_save)) * save_every
    traj = etdrk4_solve(u0, lin, nonlin, dt_inner, n_steps, save_every=save_every)
    u = np.transpose(traj, (1, 0, 2)).astype(np.float64)  # (n_ic, n_t, nx)
    t = np.arange(u.shape[1]) * dt_save
    if cache:
        np.savez_compressed(cache, u=u, t=t)
    return u, t
