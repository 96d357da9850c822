"""pnode_tpu_torch -- the PyTorch/CUDA port of pnode_tpu for one NVIDIA H100.

Neural ODE / IMEX training with hand-written stage-exact discrete adjoints,
written in PyTorch, with the JAX package's Pallas kernels rewritten by hand
in CUDA C++ for Hopper (``csrc/``, built with nvcc at first use). The JAX
package ``pnode_tpu`` is the reference; this package never imports it (nor
JAX), and keeps its module names and layout.

Quick start::

    import pnode_tpu_torch as pt
    pt.init(sys.argv)                      # -ts_* / -snes_* runtime flags
    ode = pt.ODESolver()
    ode.setupTS(y_tmpl, pt.TorchFunc(f_im), step_size=0.2, method="imex",
                imex_form=True, func2=pt.TorchFunc(f_ex),
                linear_solver="hpddm", fixed_jacobian=True, batch_size=B)
    sol = ode.odeint_adjoint(y0, t)        # loss(sol).backward() -> .grad

The stiff operators (J, the stage inverses) must stay at true fp32, so
importing the package turns TF32 off for matmuls and cuDNN.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .options import Options, clear_options, init, options_left, set_option  # noqa: E402
from .modules import DynamicsModule, Func, TorchFunc, as_dynamics  # noqa: E402
from .solver import ODESolver, ODEPnode  # noqa: E402
from .adjoint import TrajectoryConfig  # noqa: E402
from .disk_host import HostDiskTrajectory  # noqa: E402
from .tableaus import get_ark_tableau, get_rk_tableau  # noqa: E402
from .linsolve import gmres  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "init",
    "set_option",
    "clear_options",
    "options_left",
    "Options",
    "ODESolver",
    "ODEPnode",
    "DynamicsModule",
    "Func",
    "TorchFunc",
    "as_dynamics",
    "TrajectoryConfig",
    "HostDiskTrajectory",
    "get_rk_tableau",
    "get_ark_tableau",
    "gmres",
]
