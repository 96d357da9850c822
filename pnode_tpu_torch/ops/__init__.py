"""Hand-written Hopper kernels (csrc/*.cu) with their plain PyTorch versions.

- ``fused_mlp``: K1, the whole MLP stack, forward and backward.
- ``fused_ark_forward``: K2, one whole ARK-IMEX forward step.
- ``fused_ark_adjoint``: K3, one whole stage-exact reverse step.
- ``fused_train_loop``: K4, K complete training iterations (forward step,
  MSE, reverse step, Adam) in one persistent cooperative launch.
- ``fused_adaptive_loop``: K5, K complete adaptive training iterations
  (the embedded trial loop under the basic controller, MSE, the reverse of
  the accepted trials, Adam) in one persistent cooperative launch.

Each wrapper launches its kernel for CUDA tensors (counting the launch in
its ``launches`` attribute) and runs the plain version for CPU tensors.
"""

__all__ = ["fused_mlp", "fused_ark_forward", "fused_ark_adjoint",
           "fused_train_loop", "fused_adaptive_loop"]
