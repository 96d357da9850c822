"""CNF regularization functionals integrated along the trajectory.

Counterpart of ``pnode_tpu/ffjord/regularization.py`` (the reference's
RegularizedODEfunc densities and its REGULARIZATION_FNS registry: l1int,
l2int, dl2int, JFrobint, Jdiagint, Joffdiagint). Each maps the quantities
of one dynamics evaluation, ``(z, dz, div, e, Je)`` with ``Je = J e`` the
forward-mode product of the Hutchinson probe, to a per-sample density whose
time integral rides in the flow state. The Jacobian densities read ``Je``
sample by sample, so the port keeps the forward product ``J e`` (the
original FFJORD's ``e^T J`` has the same trace estimate but another norm
per sample).
"""

from __future__ import annotations

import torch


def l1_regularzation(z, dz, div, e, Je):
    return torch.mean(torch.abs(dz), dim=-1)


def l2_regularzation(z, dz, div, e, Je):
    return 0.5 * torch.sum(dz ** 2, dim=-1)


def directional_l2_regularization(z, dz, div, e, Je):
    # the probe product stands in for the reference's time-derivative
    # direction, as in the JAX package
    return 0.5 * torch.sum(Je ** 2, dim=-1)


def jacobian_frobenius_regularization(z, dz, div, e, Je):
    return torch.sum(Je ** 2, dim=-1)


def jacobian_diag_frobenius_regularization(z, dz, div, e, Je):
    # diag(J) estimated by e * (J e) for rademacher e
    return torch.sum((e * Je) ** 2, dim=-1)


def jacobian_offdiag_frobenius_regularization(z, dz, div, e, Je):
    return torch.sum(Je ** 2, dim=-1) - torch.sum((e * Je) ** 2, dim=-1)


REGULARIZATION_FNS = {
    "l1int": l1_regularzation,
    "l2int": l2_regularzation,
    "dl2int": directional_l2_regularization,
    "JFrobint": jacobian_frobenius_regularization,
    "Jdiagint": jacobian_diag_frobenius_regularization,
    "Joffdiagint": jacobian_offdiag_frobenius_regularization,
}
