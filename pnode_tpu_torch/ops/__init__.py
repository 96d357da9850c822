"""Hand-written Hopper kernels (csrc/*.cu) with their plain PyTorch versions.

- ``fused_mlp``: K1, the whole MLP stack, forward and backward.
- ``fused_ark_forward``: K2, one whole ARK-IMEX forward step.
- ``fused_ark_adjoint``: K3, one whole stage-exact reverse step.
- ``fused_train_loop``: K4, K complete training iterations (forward step,
  MSE, reverse step, Adam) in one persistent cooperative launch; and K12,
  ``fused_grad_step``, one iteration's loss and gradient without Adam (the
  per-rank kernel of the data-parallel loop, ``parallel/fused_dp.py``).
- ``fused_adaptive_loop``: K5, K complete adaptive training iterations
  (the embedded trial loop under the basic controller, MSE, the reverse of
  the accepted trials, Adam) in one persistent cooperative launch.
- ``fused_sqnxt``: K6-K9, the SqueezeNext ODE dynamics (five layers of
  conv, batch-statistics norm and ReLU) and their backward, as the whole
  chain (K6, K7) or one layer per launch (K8, K9).
- ``circular_stencil``: K10 and K11, the periodic k-point stencil along a
  row (the SINODE implicit operators) and its backward, with the forward-mode
  and vmap rules that ``torch.func.jacfwd`` needs.

Each wrapper launches its kernel for CUDA tensors (counting the launch in
its ``launches`` attribute) and runs the plain version for CPU tensors.
"""

__all__ = ["fused_mlp", "fused_ark_forward", "fused_ark_adjoint",
           "fused_train_loop", "fused_adaptive_loop", "fused_sqnxt",
           "circular_stencil"]
