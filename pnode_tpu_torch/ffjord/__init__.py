"""FFJORD continuous normalizing flows on the PyTorch/CUDA port.

Counterpart of ``pnode_tpu/ffjord/`` with the same file and class names:
the time-dependent diffeq layer zoo (``layers``), the dynamics nets with
the Hutchinson and brute-force divergences (``odefunc``), the CNF block
integrating (z, logp, regularizations) through the port's ``ODESolver``
with discrete-adjoint gradients (``cnf``), the flow containers and
non-ODE layers (``flows``, ``other_flows``), ODENVP and the
multiscale-parallel CNF (``odenvp``), ResNet blocks (``resnet``), the
regularizers, the tabular and toy data (numpy copies of the JAX package's
``datasets`` and ``toy_data``) and the model builders.

The layers are ``nn.Module``s whose parameters live in the module (the JAX
package passes them separately); a flow's ``apply`` keeps the JAX
package's signature otherwise, with a ``torch.Generator`` (or an explicit
probe) where JAX takes a PRNG key. The flow constructors take ``device=``
(``"cuda"`` by default; a CUDA device without CUDA raises).
``convert.ffjord_state_dict_from_flax`` carries a JAX flow's parameters
into the port. Nothing here launches a hand-written kernel: the dynamics
are ``nn.Linear`` / ``F.conv2d`` products, which XLA compiles outside any
Pallas kernel in the JAX package.
"""

from .layers import DIFFEQ_CONV_LAYERS, DIFFEQ_LAYERS, build_diffeq_layer
from .odefunc import (
    ODEnet,
    AutoencoderDiffEqNet,
    autoencoder_divergence_fn,
    divergence_approx_fn,
    divergence_bf_fn,
    sample_probe,
)
from .cnf import CNF
from .other_flows import (
    BruteForceLayer,
    CouplingLayer,
    MaskedCouplingLayer,
    PlanarFlow,
    SpectralDense,
)
from .flows import (
    CNFLayer,
    LogitTransform,
    MovingBatchNorm,
    SequentialFlow,
    SigmoidTransform,
    SqueezeLayer,
    ZeroMeanTransform,
)
from .regularization import REGULARIZATION_FNS
from .model_builders import build_model_tabular, standard_normal_logprob
from .odenvp import ODENVP, MultiscaleParallelCNF

__all__ = [
    "DIFFEQ_LAYERS",
    "DIFFEQ_CONV_LAYERS",
    "build_diffeq_layer",
    "ODEnet",
    "AutoencoderDiffEqNet",
    "autoencoder_divergence_fn",
    "divergence_approx_fn",
    "divergence_bf_fn",
    "sample_probe",
    "CNF",
    "CNFLayer",
    "BruteForceLayer",
    "CouplingLayer",
    "MaskedCouplingLayer",
    "PlanarFlow",
    "SpectralDense",
    "SequentialFlow",
    "LogitTransform",
    "SigmoidTransform",
    "ZeroMeanTransform",
    "MovingBatchNorm",
    "SqueezeLayer",
    "REGULARIZATION_FNS",
    "build_model_tabular",
    "standard_normal_logprob",
    "ODENVP",
    "MultiscaleParallelCNF",
]
