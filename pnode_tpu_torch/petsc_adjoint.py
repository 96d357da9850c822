"""Import-path parity with the reference: ``pnode.petsc_adjoint``.

Reference drivers do ``from pnode import petsc_adjoint`` and instantiate
``petsc_adjoint.ODEPetsc()``; as in ``pnode_tpu/petsc_adjoint.py``, porting
such a driver only changes the package name::

    from pnode_tpu_torch import petsc_adjoint
    ode = petsc_adjoint.ODEPetsc()
    ode.setupTS(u_template, func, ...)
    sol = ode.odeint_adjoint(y0, t)

There is no PETSc underneath: the name is a migration aid.
"""

from .solver import ODESolver

ODEPetsc = ODESolver

__all__ = ["ODEPetsc", "ODESolver"]
