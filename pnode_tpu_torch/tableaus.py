"""Butcher tableaus for explicit RK, theta, and additive (IMEX) ARK methods.

Capability map mirrors the reference's method-string -> PETSc mapping
(reference pnode/petsc_adjoint.py:638-656):

    euler -> rk "1fe"           (forward Euler)
    rk2   -> rk "2b"            (explicit midpoint; the reference comments that
                                 "2a is Heun's method, not midpoint" and picks 2b)
    bosh3 / fixed_bosh3 -> "3bs" (Bogacki-Shampine 3(2))
    rk4   -> rk "4"             (classical RK4)
    dopri5 / fixed_dopri5 -> "5dp" (Dormand-Prince 5(4))
    beuler -> theta(1.0)        (backward Euler)
    cn     -> theta(0.5)        (Crank-Nicolson / endpoint trapezoid)
    imex   -> ARK IMEX          (-ts_arkimex_type selects the pair)

Unknown method strings fall back to the default RK (3bs) with a warning —
replicating the reference's permissive fall-through (SURVEY.md section 2.1)
while fixing the silent-footgun.

All coefficients are standard published values (Bogacki & Shampine 1989;
Dormand & Prince 1980; Kennedy & Carpenter, Appl. Numer. Math. 44 (2003)
139-181 for ARK3(2)4L[2]SA and ARK4(3)6L[2]SA; Ascher, Ruuth & Spiteri 1997
for ARS(1,2,2); Pareschi & Russo 2005 for the L-stable 2nd-order pair).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class RKTableau:
    """Explicit Runge-Kutta tableau (strictly lower-triangular A)."""

    name: str
    order: int
    a: np.ndarray  # (s, s)
    b: np.ndarray  # (s,)
    c: np.ndarray  # (s,)
    b_err: Optional[np.ndarray] = None  # embedded lower-order weights
    embedded_order: int = 0
    fsal: bool = False

    @property
    def stages(self) -> int:
        return len(self.b)


@dataclass(frozen=True)
class ARKTableau:
    """Additive IMEX pair: A_im (diagonally implicit) + A_ex (explicit).

    Stage i state: Y_i = y + h * sum_j (a_im[i,j] kI_j + a_ex[i,j] kE_j)
    with kI_j = f_IM(t + c_im[j] h, Y_j), kE_j = f_EX(t + c_ex[j] h, Y_j).
    """

    name: str
    order: int
    a_im: np.ndarray
    b_im: np.ndarray
    c_im: np.ndarray
    a_ex: np.ndarray
    b_ex: np.ndarray
    c_ex: np.ndarray
    b_im_err: Optional[np.ndarray] = None
    b_ex_err: Optional[np.ndarray] = None
    embedded_order: int = 0

    @property
    def stages(self) -> int:
        return len(self.b_im)


def _arr(rows) -> np.ndarray:
    return np.array(rows, dtype=np.float64)


# ----------------------------------------------------------------------------
# Explicit RK tableaus
# ----------------------------------------------------------------------------

EULER = RKTableau(
    name="euler",
    order=1,
    a=_arr([[0.0]]),
    b=_arr([1.0]),
    c=_arr([0.0]),
)

MIDPOINT = RKTableau(
    name="midpoint",
    order=2,
    a=_arr([[0.0, 0.0], [0.5, 0.0]]),
    b=_arr([0.0, 1.0]),
    c=_arr([0.0, 0.5]),
)

HEUN = RKTableau(
    name="heun",
    order=2,
    a=_arr([[0.0, 0.0], [1.0, 0.0]]),
    b=_arr([0.5, 0.5]),
    c=_arr([0.0, 1.0]),
)

BOSH3 = RKTableau(
    name="bosh3",
    order=3,
    a=_arr(
        [
            [0.0, 0.0, 0.0, 0.0],
            [1 / 2, 0.0, 0.0, 0.0],
            [0.0, 3 / 4, 0.0, 0.0],
            [2 / 9, 1 / 3, 4 / 9, 0.0],
        ]
    ),
    b=_arr([2 / 9, 1 / 3, 4 / 9, 0.0]),
    c=_arr([0.0, 1 / 2, 3 / 4, 1.0]),
    b_err=_arr([7 / 24, 1 / 4, 1 / 3, 1 / 8]),
    embedded_order=2,
    fsal=True,
)

RK4 = RKTableau(
    name="rk4",
    order=4,
    a=_arr(
        [
            [0.0, 0.0, 0.0, 0.0],
            [0.5, 0.0, 0.0, 0.0],
            [0.0, 0.5, 0.0, 0.0],
            [0.0, 0.0, 1.0, 0.0],
        ]
    ),
    b=_arr([1 / 6, 1 / 3, 1 / 3, 1 / 6]),
    c=_arr([0.0, 0.5, 0.5, 1.0]),
)

DOPRI5 = RKTableau(
    name="dopri5",
    order=5,
    a=_arr(
        [
            [0, 0, 0, 0, 0, 0, 0],
            [1 / 5, 0, 0, 0, 0, 0, 0],
            [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
            [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
            [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
            [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0],
            [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
        ]
    ),
    b=_arr([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]),
    c=_arr([0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1, 1]),
    b_err=_arr(
        [5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
    ),
    embedded_order=4,
    fsal=True,
)

_RK_TABLEAUS = {
    "euler": EULER,
    "1fe": EULER,
    "rk2": MIDPOINT,
    "midpoint": MIDPOINT,
    "2b": MIDPOINT,
    "heun": HEUN,
    "2a": HEUN,
    "bosh3": BOSH3,
    "fixed_bosh3": BOSH3,
    "3bs": BOSH3,
    "rk4": RK4,
    "4": RK4,
    "dopri5": DOPRI5,
    "fixed_dopri5": DOPRI5,
    "5dp": DOPRI5,
}

DEFAULT_RK = BOSH3  # PETSc TSRK default is 3bs


def get_rk_tableau(method: str) -> RKTableau:
    """Resolve a method string; unknown names warn and use the default RK.

    The permissive fall-through matches the reference (strings like "rk3"
    silently hit PETSc's default RK there — SURVEY.md section 2.1); here the
    footgun gets an explicit warning.
    """
    tab = _RK_TABLEAUS.get(method)
    if tab is None:
        warnings.warn(
            f"unknown explicit method {method!r}; falling back to the default "
            f"RK tableau ({DEFAULT_RK.name}), matching PETSc's permissive "
            "behavior",
            stacklevel=2,
        )
        return DEFAULT_RK
    return tab


# ----------------------------------------------------------------------------
# ARK IMEX tableaus  (-ts_arkimex_type equivalents)
# ----------------------------------------------------------------------------

def _imex_euler() -> ARKTableau:
    """First-order stiffly-accurate IMEX Euler (PETSc "1bee" capability slot).

    y1 = y + h f_EX(t, y) + h f_IM(t+h, y1). PETSc's 1bee additionally carries
    an extrapolation-based error estimator; the embedded weights here use the
    explicit-Euler/implicit-free combination for the same purpose.
    """
    return ARKTableau(
        name="1bee",
        order=1,
        a_im=_arr([[0.0, 0.0], [0.0, 1.0]]),
        b_im=_arr([0.0, 1.0]),
        c_im=_arr([0.0, 1.0]),
        a_ex=_arr([[0.0, 0.0], [1.0, 0.0]]),
        b_ex=_arr([1.0, 0.0]),
        c_ex=_arr([0.0, 1.0]),
        b_im_err=_arr([1.0, 0.0]),
        b_ex_err=_arr([1.0, 0.0]),
        embedded_order=1,
    )


def _ars122() -> ARKTableau:
    """ARS(1,2,2) of Ascher-Ruuth-Spiteri 1997: implicit+explicit midpoint."""
    return ARKTableau(
        name="ars122",
        order=2,
        a_im=_arr([[0.0, 0.0], [0.0, 0.5]]),
        b_im=_arr([0.0, 1.0]),
        c_im=_arr([0.0, 0.5]),
        a_ex=_arr([[0.0, 0.0], [0.5, 0.0]]),
        b_ex=_arr([0.0, 1.0]),
        c_ex=_arr([0.0, 0.5]),
    )


def _l2() -> ARKTableau:
    """L-stable 2nd-order IMEX pair (Pareschi-Russo SSP2(2,2,2) family).

    gamma = 1 - 1/sqrt(2); the implicit part is the L-stable SDIRK2.
    Fills the reference's ``-ts_arkimex_type l2`` capability slot
    (reference examples-sinode/KS/runs64_a100.sh).
    """
    g = 1.0 - 1.0 / np.sqrt(2.0)
    return ARKTableau(
        name="l2",
        order=2,
        a_im=_arr([[g, 0.0], [1.0 - 2.0 * g, g]]),
        b_im=_arr([0.5, 0.5]),
        c_im=_arr([g, 1.0 - g]),
        a_ex=_arr([[0.0, 0.0], [1.0, 0.0]]),
        b_ex=_arr([0.5, 0.5]),
        c_ex=_arr([0.0, 1.0]),
    )


def _ark3() -> ARKTableau:
    """ARK3(2)4L[2]SA of Kennedy & Carpenter 2003 (PETSc ARKIMEX default "3")."""
    g = 1767732205903 / 4055673282236
    b = _arr(
        [
            1471266399579 / 7840856788654,
            -4482444167858 / 7529755066697,
            11266239266428 / 11593286722821,
            g,
        ]
    )
    b_err = _arr(
        [
            2756255671327 / 12835298489170,
            -10771552573575 / 22201958757719,
            9247589265047 / 10645013368117,
            2193209047091 / 5459859503100,
        ]
    )
    c = _arr([0.0, 2 * g, 3 / 5, 1.0])
    a_im = _arr(
        [
            [0.0, 0.0, 0.0, 0.0],
            [g, g, 0.0, 0.0],
            [
                2746238789719 / 10658868560708,
                -640167445237 / 6845629431997,
                g,
                0.0,
            ],
            list(b[:3]) + [g],
        ]
    )
    a_ex = _arr(
        [
            [0.0, 0.0, 0.0, 0.0],
            [2 * g, 0.0, 0.0, 0.0],
            [
                5535828885825 / 10492691773637,
                788022342437 / 10882634858940,
                0.0,
                0.0,
            ],
            [
                6485989280629 / 16251701735622,
                -4246266847089 / 9704473918619,
                10755448449292 / 10357097424841,
                0.0,
            ],
        ]
    )
    return ARKTableau(
        name="3",
        order=3,
        a_im=a_im,
        b_im=b,
        c_im=c,
        a_ex=a_ex,
        b_ex=b,
        c_ex=c,
        b_im_err=b_err,
        b_ex_err=b_err,
        embedded_order=2,
    )


def _ark4() -> ARKTableau:
    """ARK4(3)6L[2]SA of Kennedy & Carpenter 2003 (PETSc ARKIMEX "4")."""
    b = _arr(
        [
            82889 / 524892,
            0.0,
            15625 / 83664,
            69875 / 102672,
            -2260 / 8211,
            1 / 4,
        ]
    )
    b_err = _arr(
        [
            4586570599 / 29645900160,
            0.0,
            178811875 / 945068544,
            814220225 / 1159782912,
            -3700637 / 11593932,
            61727 / 225920,
        ]
    )
    c = _arr([0.0, 1 / 2, 83 / 250, 31 / 50, 17 / 20, 1.0])
    a_im = _arr(
        [
            [0, 0, 0, 0, 0, 0],
            [1 / 4, 1 / 4, 0, 0, 0, 0],
            [8611 / 62500, -1743 / 31250, 1 / 4, 0, 0, 0],
            [5012029 / 34652500, -654441 / 2922500, 174375 / 388108, 1 / 4, 0, 0],
            [
                15267082809 / 155376265600,
                -71443401 / 120774400,
                730878875 / 902184768,
                2285395 / 8070912,
                1 / 4,
                0,
            ],
            list(b[:5]) + [1 / 4],
        ]
    )
    a_ex = _arr(
        [
            [0, 0, 0, 0, 0, 0],
            [1 / 2, 0, 0, 0, 0, 0],
            [13861 / 62500, 6889 / 62500, 0, 0, 0, 0],
            [
                -116923316275 / 2393684061468,
                -2731218467317 / 15368042101831,
                9408046702089 / 11113171139209,
                0,
                0,
                0,
            ],
            [
                -451086348788 / 2902428689909,
                -2682348792572 / 7519795681897,
                12662868775082 / 11960479115383,
                3355817975965 / 11060851509271,
                0,
                0,
            ],
            [
                647845179188 / 3216320057751,
                73281519250 / 8382639484533,
                552539513391 / 3454668386233,
                3354512671639 / 8306763924573,
                4040 / 17871,
                0,
            ],
        ]
    )
    return ARKTableau(
        name="4",
        order=4,
        a_im=a_im,
        b_im=b,
        c_im=c,
        a_ex=a_ex,
        b_ex=b,
        c_ex=c,
        b_im_err=b_err,
        b_ex_err=b_err,
        embedded_order=3,
    )


def _ark5() -> ARKTableau:
    """Derived L-STABLE 8-stage order-5(4) pair (tools/derive_ark5l.py).

    Fills the ``-ts_arkimex_type 5`` slot, matching the properties of
    Kennedy-Carpenter ARK5(4)8L[2]SA (PETSc's "5"): ALL additive order-5
    colored-tree conditions to machine precision, an L-STABLE stiffly
    accurate ESDIRK implicit part (|R(-inf)| = 2e-16 exactly, gamma ~=
    0.2003), and embedded order-4 weights enabling ``-ts_adapt_type basic``
    at order 5. Full colored-tree + stability validation in tests.
    """
    from . import tableaus_ark5l as t5

    return ARKTableau(
        name="5",
        order=5,
        a_im=np.asarray(t5.A_IM),
        b_im=np.asarray(t5.B),
        c_im=np.asarray(t5.C),
        a_ex=np.asarray(t5.A_EX),
        b_ex=np.asarray(t5.B),
        c_ex=np.asarray(t5.C),
        b_im_err=np.asarray(t5.BHAT),
        b_ex_err=np.asarray(t5.BHAT),
        embedded_order=4,
    )


def _ark5a() -> ARKTableau:
    """Round-1's derived order-5 pair (tools/derive_ark5.py): A-stable on
    the sampled left half-plane (|R(-inf)| = 0.17, not L-stable), no
    embedded weights. Kept as ``-ts_arkimex_type 5a`` for reproducibility;
    "5" is the L-stable successor."""
    from . import tableaus_ark5 as t5

    return ARKTableau(
        name="5a",
        order=5,
        a_im=np.asarray(t5.A_IM),
        b_im=np.asarray(t5.B),
        c_im=np.asarray(t5.C),
        a_ex=np.asarray(t5.A_EX),
        b_ex=np.asarray(t5.B),
        c_ex=np.asarray(t5.C),
    )


_ARK_TABLEAUS = {
    "1bee": _imex_euler,
    "ars122": _ars122,
    "l2": _l2,
    "3": _ark3,
    "4": _ark4,
    "5": _ark5,
    "5a": _ark5a,
    "a2": _l2,  # A-stable slot: serve the L-stable 2nd-order pair
}

DEFAULT_ARK = "3"  # PETSc TSARKIMEX default


def get_ark_tableau(name: Optional[str] = None) -> ARKTableau:
    key = name or DEFAULT_ARK
    if key in ("5", "5a"):
        try:
            return _ARK_TABLEAUS[key]()
        except ImportError:
            warnings.warn(
                "derived ARK5 tableau unavailable; using ARK4(3)6L[2]SA",
                stacklevel=2,
            )
            key = "4"
    factory = _ARK_TABLEAUS.get(key)
    if factory is None:
        warnings.warn(
            f"unknown -ts_arkimex_type {key!r}; using default ({DEFAULT_ARK})",
            stacklevel=2,
        )
        factory = _ARK_TABLEAUS[DEFAULT_ARK]
    return factory()


# Theta-method parameters for the implicit single-stage family.
THETA_METHODS = {
    "beuler": 1.0,  # PETSc TSBE
    "be": 1.0,
    "cn": 0.5,  # PETSc TSCN (endpoint trapezoid)
    "theta": 0.5,
}
