#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pnode_tpu_torch) on one NVIDIA H100.

Run from the repository root on a machine with the card::

    python3 chip_smoke.py

It imports no JAX. Phases, each of which raises on failure (so the script
exits non-zero without printing the final line):

1. Device: CUDA present, compute capability 9.0; prints the card's name and
   power limit as nvidia-smi reports them.
2. Build: compiles pnode_tpu_torch/csrc/*.cu for sm_90a with nvcc (timed);
   fails where ptxas reports spill in csrc/sqnxt_fwd.cu (K6, K8),
   csrc/fused_sqnxt.cu (K7, K9), csrc/fused_ark_forward.cu (K2),
   csrc/fused_ark_adjoint.cu (K3),
   csrc/fused_grad_step.cu (K12), csrc/fused_train_loop.cu (K4) or
   csrc/fused_adaptive_loop.cu (K5), and where K2's, K3's, K12's, K4's or
   K5's C plan (rows per block, grid, shared memory; K5's workspace)
   differs from its Python mirror at FWD_PLANS (K3, K12 and K4 also at the
   DP shards, K4 and K5 at LOOP_PLANS and at every forced R of phase 3's
   loop cases), or the grid form's (grid, shared memory, workspace; of
   its four kinds, K3's, K4's, K12's and K2's, where the row form cannot
   keep inv and J resident) at the shapes that take it, or the grid form's
   phases (its products, listed by the C generator on the host, all four
   kinds) from their mirror's at grid_phase_cases, or K6-K9's
   shared-memory regions (staged tile and weights, both dtypes, chain and
   each layer, forward and backward) from stage_layout at the stage shapes
   and every SQNXT_EDGES and SQNXT_BF16_EDGES case; and unless the SASS
   of the SqueezeNext cubins (cuobjdump, in other processes beside the
   plan checks and the probe, waited for at the phase's end) holds bf16
   HMMA in all four bf16 instances (K6's and K7's chain, K8's and K9's
   one layer) and none in any fp32 SqueezeNext function.
   Then the probe (python -m pnode_tpu_torch.tools.probe_smem_limit, K13):
   the largest dynamic shared memory one block takes, up a ladder and
   bisected to 4 bytes, must equal the gates' MAX_SMEM_BYTES and the card's
   opt-in attribute; the grids the cooperative kernels take; K13 at sizes
   its bulk copies do not reach (probe_edges) and at
   the largest size against 3x (bitwise), timed beside it and
   torch.mul(x, 3), by CUDA events and by the profiler's device time.
3. Kernels: K1 forward, K1 backward, K2 (ARK forward step) and K3 (ARK
   reverse step) against their plain PyTorch versions on the card, at the
   main path's shapes (B 256, 64 -> 104 x4 -> 64, ARK3, dt 0.2, J and the
   stage inverse from the port's own KSFuncIM) and at a ragged size (B 37,
   hidden 24, nonzero biases), on KS states from the port's generator (the
   inputs the main path gives the kernels): max relative error (max |diff|
   / max |ref|) against the fp32 plain version (<= 1e-5 forward outputs,
   <= 1e-4 gradients and lam_prev) and against the plain version in
   float64 (<= 1e-4); median per-call times of kernel and plain version
   over CUDA events (30 samples of 10 back-to-back calls each). K1 also at
   the edges of its 32 x 32 tiling (K1_EDGES: B 1, B 37, widths 13 and
   100, 1 and 8 layers, tanh) with the same gates, every K1 backward
   repeated bitwise, and scratch one float short refused. K2 at the edges
   of its plan and tiling (K2_EDGES: B 1, 37 and 3173, widths 13 and 100,
   1 and 8 layers, tanh, 2, 6 and 8 stages, the Burgers forward at d 512,
   B 200), with and without err, against the plain versions in fp32 and
   fp64, each call repeated bitwise (phase_k2_edges says how it gates);
   the device times of K2 (with and without err) and K3. K3 at the edges
   of its plan and tiling (K3_EDGES: K2's, the Burgers reverse at d 512
   on BurgersFuncIM's J and stage inverse at dt 1e-3, a stack whose layer
   store the plan shrinks, d 200 and 300, and d 197 with a 201-wide layer;
   from d 197 up the plan takes the grid form and the forced R read inv
   and J in place) in the plan's form and at every forced R that fits:
   against the plain versions in fp32 and fp64 with K3's gates, lam_prev
   bitwise equal across the forms and R, each call repeated bitwise;
   at d 512 the ReLU decisions on which kernel and plain version part are
   printed first (relu_flips). Then K4,
   the fused training loop, against fused_train_loop_plain on K = 8
   distinct KS minibatches (Adam lr 5e-3) at every rows per block its plan
   takes (1, 2, 4, 8): the main path's shapes, the ragged size (chunk=8),
   an odd hidden width 13 (the 4-byte weight copies, read through L2) and
   a batch whose row tiles outnumber the grid's blocks (check_loop says how
   it gates), and its grid form at LOOP_GRID_CASES (d 200 at B 37, rows of
   197 and 201 floats, one layer; per iteration on the kernel's
   trajectory, bitwise across two calls and across the plan's grid and
   half of it); K = 16 as two chunks of 8 against one launch; two calls
   bitwise equal; per-iteration times in turns and the device time. K2
   with its embedded error output (the adaptive trial step) at both sizes
   (check_embedded). K5, the fused adaptive loop, against
   fused_adaptive_train_loop_plain on K = 8 KS minibatches (rtol = atol =
   1e-4, 32 trials) at every rows per block its plan takes: the main path
   from a dt0 warmed by a probe call, the ragged case, the odd width, a
   cold dt0 = 0.2 that must reject, and a batch whose row tiles outnumber
   the grid's blocks (check_adaptive says how it gates); two calls bitwise
   equal, K/2 + K/2 launches bitwise equal to one of K; per-iteration
   times in turns and the device time. Then Burgers-512 on bench.py's
   recipe (phase_burgers_kernels: B 200, 512 -> 576 x4 -> 512, dt 1e-3,
   BurgersFuncIM's operators, the seed-0 BurgersFuncEX stack, f_EX =
   +MLP, y ~ N(0, 1), target y + 0.05 N(0, 1)): K2 (without and with err)
   and K3 against their plain versions with the gates above, each in its
   plan's grid form (at the plan's grid and at half of it) and in the row
   form at forced R (K2's 2, K3's 1: the forms the plans took before the
   grid form); K12 at (200, 512) and at the two-rank shard (100, 512)
   (check_grad_step), in the grid form at both grids, its gradient bitwise
   equal to the K2 -> seed -> K3 chain's (grad_grid_checks); K4 over K =
   8 distinct minibatches (check_loop, K4's gates) in the grid form and
   in the row form at forced R 1 (132 blocks, 68 of them taking a second
   row tile); K2's y1, stage values and err bitwise equal across two
   calls, the two grids and the row form; K3's lam_prev, dW and db, K12's
   loss and gradient and K4's parameters, moments and losses bitwise
   equal across two calls and across the plan's grid and half of it, K3's
   lam_prev bitwise equal to the row form's; each timed in turns with its
   plain version and the row form, by the profiler, and by the device
   memory one call allocates.
4. The slice: KS SINODE training through ODESolver.odeint_adjoint at full
   width, batch 256, torch.optim.Adam at lr 5e-3, on KS data from the
   port's generator. (a) 4 Adam iterations on the kernel path against the
   generic stage loop through K1 (-pnode_fused_ark_adjoint off), from the
   same weights and batches: per-step loss and gradients, free-running
   loss trajectories and final parameters, all gated at 5e-4
   (phase_paths_agree says how). (b) 200 iterations on the kernel path:
   finite losses, mean of the last 20 below the mean of the first 20;
   steps/s of the kernel path and of the plain path (the nn.Linear model
   on the generic loop, no kernels). Every kernel's launch count over
   (a) + (b) must be above 0. (c) The fused-loop path of
   examples/ks_torch.py --fused_loop (K4) from the same weights and
   batches: its first 4 iterations against (a)'s per-step kernel path in
   (a)'s form; a traced call of 20 iterations (the device's busy share);
   then 200 iterations as a warm launch of 20 and a timed
   launch of 180: finite losses, the last 20 below the first 20 and
   within 10% of (b)'s, steps/s beside (b)'s; K4's launch count over the
   200 iterations must be above 0.
5. The adaptive slice (-ts_adapt_type basic, rtol = atol = 1e-4, the
   dt_first warm start), same width and batch: (a) 4 Adam iterations on
   the per-step adaptive kernel path (K2 with err, K3) against the generic
   adaptive path (phase_adaptive_paths_agree says how); (b) 50 iterations
   on the kernel path: finite losses, the last 10 below the first 10,
   steps/s and trials per iteration; (c) examples/ks_torch.py --fused_loop
   -ts_adapt_type basic (K5): its first 4 iterations against (a)'s generic
   path, a traced call of 20 iterations, then a warm launch of 20 and a
   timed launch of 180. The launch counts of K2's err output, K3 and K5
   over the phase must be above 0.
6. The CIFAR slice: SqNxt-23 ODE at full width (stage channels 32, 64, 128,
   256), batch 128, rk4, Nt 2, on the JAX trainer's synthetic surrogate.
   (a) K6-K9 (the fused SqueezeNext dynamics: chain forward and backward,
   layered forward and backward) against their plain versions in fp32 and
   in fp64 with fp64 statistics (forward: <= 1e-5 and 1e-4 relative to
   max |ref|; gradients: <= 5e-3 norm-wise, check_grads says why), on the
   first ODE block's input of each
   stage (from the model's own forward) in both modes and at the edges of
   the kernels' tiling (SQNXT_EDGES: ragged, no power of two, H = 1, W =
   1, N below a tile); conv-bias gradients, whose true value is 0, in
   absolute terms (check_bias); two calls of each kernel bitwise equal; K6
   and K7 refuse scratch one float short; each timed per evaluation beside
   its plain version and the module path's evaluation, and by the
   profiler's device time (the JSON line: K6/K7 at stage 2 with a stage3
   sub-object, K8/K9 at stage 1). The build phase fails where ptxas
   reports spill in csrc/sqnxt_fwd.cu or csrc/fused_sqnxt.cu. (b) The
   kernel path against the module path
   from the same weights: logits, loss, gradient cosine and norm ratio
   (CIFAR_TOL). (c) On cuDNN's deterministic algorithms (so the losses
   repeat from run to run): after each of the kernel path's first 2 SGD
   steps (lr 0.1, momentum 0.9, wd 5e-4), the module path at its weights
   on the next batch, as (b); then 12 SGD iterations on the kernel path
   and 6 on the module path: finite losses, the mean of
   the last 5 below the first 5, images/s after 2 warm iterations, peak
   device memory; one traced iteration each (K6-K9's milliseconds and
   shares in it); K6-K9's launch counts over the kernel path's iterations
   must be above 0.
7. The Burgers slice, bench.py's burgers recipe (B 200, nx 512, dt 1e-3,
   ARK3, hpddm + frozen J + ksponly + ksp_rtol 1e-6, one-step MSE, Adam lr
   5e-3, seed-0 weights; y0 ~ N(0, 1), target y0 + 0.05 N(0, 1), a fresh
   minibatch per iteration). (a) K10 and K11 (the circular stencil and its
   backward) against their plain versions in fp32 and fp64 at the Burgers
   stage (200, 512) k 3, the KS stage (256, 64) k 5 and the other
   STENCIL_CASES (ragged, rows too wide to stage, k > N, 512 blocks, k > N
   and an even k on the register tile), with random asymmetric taps
   (phase_stencil_kernels says how it gates): dy and dw, K11 without its
   dw pass, two K11 calls bitwise equal, the autograd Function with a
   learnable stencil, torch.func.jacfwd through K10 against the dense
   circulant; a trace of one device kernel per K10 and K11 call in every
   mode and through BurgersFuncIM; timed (K11 without dw, the main path's
   mode, and with dw) beside the plain versions, nn.Conv1d (circular, no
   bias, cuDNN TF32 off) forward and backward and the launch floor (the
   JSON line's ``with_dw`` and ``ks_stage`` entries). K1 forward and backward at
   the Burgers stack (512 -> 576 x4 -> 512) against its plain versions,
   its scratch sizes, the device memory one backward allocates, a second backward equal bitwise, times in turns with the
   plain version (the JSON line's ``burgers`` entries of K1). (b) The
   kernel path on the fused ARK step kernels (K2 forward, K3 reverse; the
   JAX package's route) and, under -pnode_fused_ark_adjoint off, on the
   generic stage loop (f_EX on K1, f_IM on K10/K11), each against the
   plain path (nn.Linear, the roll chain) over 4 iterations
   (phase_burgers_paths_agree, phase 4(a)'s form with the Burgers
   gates), the frozen J through K10 equal to the roll chain's bitwise;
   50 iterations on K2/K3 and 20 on the off path (finite losses, the mean
   of the last 10 below the first 10), steps/s of the three paths, one
   traced iteration each. K2's and K3's launch counts over the K2/K3
   runs must be above 0; over the off runs K1's forward and backward,
   K10's and K11's above 0 and K2's and K3's 0. (c)
   examples/burgers_torch.py with bench.py's numerics (--linear_solver
   hpddm --fixed_jacobian: K2/K3), --batch_time 2, 3 iterations and 20
   ICs of data: a finite loss. (d) bench.py's Burgers training loop on
   the port (phase_burgers_loop): K4 on the operands of the stepper's
   fused gate (ks_torch's FusedLoop), its first 4 iterations against
   (b)'s K2/K3 runs in (b)'s form; a traced launch of 20 iterations (busy
   share, K4's device time); a launch of 20 and a timed launch of 300 on
   fresh minibatches: finite losses, the last 20 below the first 20,
   steps/s beside (b)'s three paths; K4's launches above 0.
8. The data-parallel slice at the KS main path's shapes (B 256, 64 -> 104
   x4 -> 64, ARK3, dt 0.2, frozen J, ksponly, Adam lr 5e-3, KS states).
   (a) K12 (fused_grad_step) against its plain version in fp32 and fp64 at
   B_local 256, 128, 64 and 32 (the shard at world 1, 2, 4 and 8) and at B
   37, hidden 24, with phase 3's K3 gates, at the plan's rows per block and
   at every forced R that fits; per call beside its plain version, and its
   device time; K12 and K2 in the grid form at B 256 (which their plans
   never take at KS) against their plain versions, K2's bitwise the row
   form's, each timed beside the row form (ks_grid_reading). (b)
   dp_fused_train_loop in a spawned one-rank NCCL group with
   force_general, K = 8 iterations against K4 on the same full batch in
   phase 4(a)'s form (runs_agree); without force_general K4 launches and
   K12 does not. (c) The same over gloo in groups of 2 and 4 processes on
   the one card: every rank against K4, the parameters bitwise equal
   across ranks. (d) Iterations/s of the general path at world 1 beside
   K4's over 180 iterations, and a traced call's device-busy share. (e)
   torchrun --standalone --nproc_per_node 1 examples/ks_torch.py --dp 1 for
   one epoch of 3 iterations: its train loss equal to the run without --dp
   within 1e-5 relative. K12's launches over (b) and (c) must be above 0.
   (f) Burgers-512 (dp_burgers_case, check_dp_burgers; its ranks run in
   (b)'s and (c)'s groups of 1 and 2): dp_fused_train_loop with
   force_general on bench.py's recipe at world 1 (K12 at B 200) and over
   gloo in a group of 2 processes on the one card (K12 at B 100 on each),
   K = 8 iterations against K4 on the full batch per step and in phase
   7(b)'s form, the 2 ranks bitwise equal, K12 launched on every rank;
   the DP loop's iterations/s at world 1 beside K4's.

9. The theta slice (CN with mass matrices, matrix-free GMRES, the solve
   without the adjoint). (a) K10 and K11 under torch.func at the KS snode
   (128, 64) k 5 and the Burgers (200, 512) k 3 fixed stencils: jvp
   through K10 bitwise equal to the roll chain's, vjp through K11 bitwise
   equal to K11's plain version and within 1e-6 of autograd's vjp through
   the roll chain (phase_theta_stencil says why not bitwise). (b) One GMRES
   stage solve of the snode's CN operator at a (128, 64) KS state: the
   residual within -ksp_rtol, the dense fp64 solve of the same operator
   within cond(A) x 2 rtol, iterations and cycles, and the solve's host
   reads (one per cycle and one before) under torch.cuda's sync check.
   (c) examples/ks_torch.py's snode / cn / petsc recipe at hidden 200,
   batch 128: at step 1 the kernel path (the stencil on K10/K11) against
   the plain path (loss and gradient within 1e-4) and the gradient's
   cosine against the port's CPU fp64 run (>= 0.999); 5 Adam steps that
   lower the loss, steps/s, Newton and GMRES iterations per step, one
   traced step's busy share; K10's and K11's launches above 0. (d)
   examples/burgers_torch.py --node's computation at B 200, nx 512: dopri5
   at 1e-3 over 100 steps, autograd through the steps, the kernel path
   (K1, K10/K11) against the plain path (loss and gradient within 1e-4),
   K1's, K10's and K11's launches above 0, iterations/s, peak memory. (e)
   examples/pendulum_dae_torch.py for 4 iterations: the loss goes down,
   the first loss within 1e-5 of the port's CPU fp64 run, the constraint
   violation.
10. The checkpointed trajectories and the new drivers. (a) KS IMEX at B
   256, seed-0 weights, full width, a 100-step window of dt 0.2 from the KS
   data with outputs at every 10th step and the MSE against the data
   there: one gradient (loss, dL/dy0, dL/dtheta) through odeint_adjoint
   under each of store_all, solution_only, checkpoint, revolve and cams
   (-ts_trajectory_max_cps_ram 8), on the kernel path (K2 steps and
   re-steps, K3 reverses) and on the generic path (-pnode_fused_ark_adjoint
   off: K1 in every step): each policy's gradient bitwise store_all's; the
   steps counted (StepCounter: the engine's re-steps after the original
   pass apart from the stage recomputes inside step_adj) equal to the
   planners' costs (traj_costs gives the formula); the planners built from
   csrc/ loaded; on the kernel path seconds per gradient (best of 3) and
   the peak device memory above the pre-solve baseline, revolve's and
   CAMS's below half of store_all's; one replayed step (a re-step and a
   step_adj with aux=None) traced on each path (K1's, K2's and K3's device
   time), and K1's device time per call at the KS stack; K1's, K2's and
   K3's launches over (a) above 0. (b) examples/spiral_torch.py --niters
   40 --test_freq 20, spiral_unstable_torch.py --niters 12 and
   rober_torch.py --niters 20 --test_freq 10 on the card, each in a
   subprocess, beside each one's first iteration on the CPU in fp64: the
   losses fall (the mean of the last quarter below the first quarter's),
   the first loss within DRIVER_TOL of the CPU's, seconds per iteration;
   then rober_torch.py --hotstart resumes after its best checkpoint and
   refuses a checkpoint of another normalization. (c) examples/ks_torch.py
   at its defaults (snode, cn, petsc: K10/K11 under torch.func) for one
   epoch of 4 iterations on its first minibatch throughout, finite losses
   that fall, and examples/burgers_torch.py at its defaults (ARK3 IMEX,
   Newton on GMRES: K1 in f_EX, K10/K11 under GMRES's jvp and vjp) for
   one iteration of a 2-output window, a finite loss; the launches of
   their kernels above 0. (b) runs while (c) does.
11. The adaptive path's trajectory policies, disk, bf16 storage and bf16
   states. (a) KS IMEX at B 256, seed-0 weights, full width, under
   -ts_adapt_type basic (rtol = atol = 1e-4, 64 trial slots, dt0 0.2),
   outputs at t = 0, 0.4, ..., 2.0 and the MSE against the KS data there:
   one gradient through odeint_adjoint under each of store_all,
   solution_only, checkpoint, revolve and cams (c 4) and disk (chunk 16),
   on the kernel path (K2 with err in the trials, K2 re-steps, K3) and on
   the generic path (K1): each policy's loss, dL/dy0 and dL/dtheta bitwise
   store_all's; the re-steps and stage recomputes after the trials
   (StepCounter) equal to the plans' costs over the accepted trials
   (adaptive_costs); on the kernel path seconds per gradient (best of 3)
   and peak device memory above the pre-solve baseline; K1's, K2's (with
   and without err) and K3's launches above 0. (b) store_all,
   solution_only and revolve with -pnode_trajectory_dtype bfloat16 on the
   kernel path: loss and gradients within 2e-2 (norm-wise) of the exact
   store_all's, time and peak beside (a)'s. (c) The reference's two disk
   gates (tools/hardware_smoke.py:427-505): the explicit disk driver
   against the in-memory adjoint on the KS IMEX model at B 16, nx 16,
   hidden 24 (12 steps, an interior output, chunk 5) and on the adaptive
   dopri5 solve of the MLP alone (48 trial slots, chunk 16): max gradient
   difference below 1e-3 of the gradient's scale. (d) A bf16 state at
   tests/test_bf16_state.py's shapes (rk4, dopri5, cn, beuler, IMEX, the
   frozen-Jacobian block solver, the adaptive controller) against fp32 at
   that file's tolerances. (e) dp_value_and_grad under revolve (c 3, a
   10-step window, two outputs) on a gloo group of 2 processes on the one
   card against the single process on the whole batch: loss within 1e-5,
   gradient within 1e-4 norm-wise, every rank on revolve launching K2 and
   K3, the ranks' gradients bitwise equal.
12. bf16 CIFAR: phase 6's model and recipe (SqNxt-23, B 128, rk4, Nt 2)
   with SqueezeNextODE(dtype="bf16"). (a) The bf16 instances of K6-K9
   against their plain bf16 versions on the bf16 model's stage
   activations and at every SQNXT_EDGES and SQNXT_BF16_EDGES case, K8 and
   K9 also at stage 1 at B 256, the layered mode's shape in (d):
   outputs, dx and parameter
   gradients within BF16_TOL (2^-6, max |diff| / max |plain|); K7's
   anchors against the plain forward's and its gradients against the plain
   backward on its own forward (k7_anchored_plain); its distance from the
   free plain backward printed, not gated; conv biases absolutely; each
   kernel twice bitwise; each timed per evaluation beside its fp32
   instance, its plain version and the bf16 module path (CUDA events and
   the profiler, or CUDA events around single calls where a trace holds
   none of its launches, labelled device_source; the JSON line at stage
   1, K6/K7 with stage2 and stage3).
   (b) The bf16 kernel path against the bf16 module path from the same
   weights (CIFAR_BF16_TOL: the loss, the head's gradient cosine); one ODE
   block's gradient at each stage (stage 1 also layered) on both paths
   from the same input and cotangent (BF16_BLOCK_TOL: each tensor's
   cosine and norm ratio), beside the bf16-against-fp32 control; its
   argmax against the fp32 kernel path's. (c) 12 SGD iterations on the
   bf16 kernel path (the mean of the last 5 losses below the first 5) and
   6 on the bf16 module path: images/s and peak memory, the bf16 kernel
   path's images/s over its last 10 beside phase 6(c)'s fp32 kernel path
   over its last 10 (not gated), one traced iteration of the bf16 kernel
   path (K6-K9's shares of it), and one more of a fresh bf16 kernel path
   at B 256 (profile_cifar_bf16_at); the bf16 instances' launches. (d)
   examples/train_cifar10_torch.py --precision bf16 at B 256 (stage 1 runs
   layered there) for 2 iterations with --use_kernels on and off, its
   memstat.txt carrying the precision; every bf16 instance launched over
   (c) and (d).
13. Slice 10: tools/hardware_smoke.py's gate 1 (one ARK3 IMEX step on the
   KS data, u[300:428], B 128, hpddm, frozen J, ksponly: MSE below 50x
   the identity's) and gate 4 (the one-step MSE gradient by
   odeint_adjoint on the card in fp32 against the port's CPU fp64 run
   from the same weights: cosine above 0.99); WindowedLoader built and
   iterated; examples/ks_torch.py on the main path's flags for 2 epochs,
   then --hotstart to 3; annotate's span inside a trace()d step and
   device_memory_gb.
14. FFJORD (no hand-written kernel on its path: every kernel's launch
   count is zeroed before (a)'s iterations and read after, and must stay
   0). (a) examples/ffjord_tabular_torch.py's miniboone recipe at full
   width (D 43, 860-860, concatsquash, softplus, rk4 dt 0.25 over T 1, B
   1000, Rademacher probe, Adam lr 1e-3 wd 1e-6) on the synthetic
   surrogate, through the driver's functions: one iteration's gradient
   through the discrete adjoint on the card in fp32 against the port's CPU
   fp64 run at the same weights, batch and probe (cosine above 0.9999);
   the brute-force NLL of tst[:1000] before and after, finite; 3 warm and
   10 timed iterations (iterations/s, NFE-F per iteration, peak memory),
   one traced iteration (the busy share). (b) x -> z -> x of tst[:1000]
   through the trained model: within 1e-4 of max |x|, delta_logp
   cancelling to 1e-4. (c) tools/hardware_smoke.py's gate 5: ODENVP((8, 8,
   1), 2 scales, hidden 8) takes 10 Adam steps at 1e-3 on 16 images; the
   fixed-probe NLL falls, every gradient finite. (d)
   examples/ffjord_image_torch.py (ODENVP on the MNIST surrogate, B 64) for
   6 iterations and ffjord_toy_torch.py (8gaussians, dopri5, B 512) for
   12, at their defaults otherwise, each in a subprocess: iterations/s and
   images/s.
15. GRAND (no hand-written kernel on its path: every kernel's launch
   count is zeroed at the phase's start and must read 0 after (c)). (a)
   examples/grand_node_torch.py's defaults (hidden 64, dopri5 dt 0.5 over
   T 3, AdamW lr 0.01 wd 5e-4, dropout 0.5 / 0.5 from a seeded generator)
   at Cora's scale (the SBM surrogate: 2,708 nodes, 1,433 features, 7
   classes, 13,278 edges with self loops), through the driver's functions,
   for laplacian/pnode and transformer/imex (heads 4): one CE gradient
   through the discrete adjoint on the card in fp32 against the port's CPU
   fp64 run at the same weights (cosine >= 0.9999, CE within 1e-5
   relative); 3 warm and 10 timed full-batch epochs (transformer/imex,
   ~3 s an epoch: 1 and 2) (epochs/s, peak memory, accuracies; the CE
   falls), one traced epoch (the busy share, launches). (b)
   tools/hardware_smoke.py's gate 6: six GRAND families on a 96-node SBM
   take 8 Adam steps (the CE falls, gradients finite), and GRANDImage at 8
   x 8 takes 12 (6b). (c) GRANDImage at MNIST's shape (28 x 28, B 256,
   rk4 0.25 over T 1) on random pixels: one gradient's cosine against CPU
   fp64, 20 timed Adam iterations (images/s), one traced. (d)
   grand_node_torch.py (10 epochs), grand_image_torch.py (one epoch of
   its surrogate) and grand_sweep_torch.py (one random trial of 3 epochs)
   in subprocesses, all three at once.

Phases 1-6 run at their full depth but phase 6(c) (12 and 6 iterations,
22 and 12 before phase 12 came); phase 3's Burgers checks add about 30
s, phase 7 about 25 s, phase 8 about 95 s, phase 9 about 75 s, phase 10 about 130 s, phase 11 about 40 s,
phase 12 about 90 s, phase 13 a few seconds, phase 14 about 100 s,
phase 15 about 100-130 s (8(f)'s ranks run in 8(b)'s and 8(c)'s
groups; phases 9(e), 12(c), 14(a) and 15(a) run fewer timed iterations
than they once did, to keep the whole script's time); the build
about 90 s.

The line before the last is a JSON object with one entry per kernel (K1's
two also carry ``burgers``: its readings at the Burgers stack and its
launches over phase 7(b); K1's, K10's and K11's carry ``theta_launches``:
their launches over phase 9's snode CN path (c) and Burgers --node path
(d); K1-K3, K10 and K11 carry ``slice5_launches``, their launches over
phase 10(a) and (c), and K1-K3 ``replayed_step``, their device time per
launch and launches in one replayed step of phase 10(a); K1-K3 carry
``slice5b_launches``, their launches over phase 11(a), (b) and (e);
K1-K13 carry
``device_ms``, the profiler's
device time per call (K4 and K5: per iteration); K6 and K7 ``stage3``:
their readings at stage 3; the bf16 instances carry ``fp32_ms`` (their
fp32 instance), ``module_ms`` (the bf16 module path), ``max_rel_err``
and, for K6/K7, ``stage2`` and ``stage3``, K7's also
``free_norm_err`` and ``free_max_rel_err`` (against the free plain
backward, not gated); K1-K3 carry
``slice10_launches``, their launches over phase 13's gates; K2, K3, K4
and K12 carry ``burgers``: their readings at Burgers-512 (phase 3) with
their launches over phase 7(b)'s K2/K3 runs (K2, K3), 7(d) (K4) and 8(f)
(K12); each also its plan's ``form``, ``grid``, ``smem_bytes``,
``workspace_bytes`` and ``peak_bytes``, and the row form's at forced R
(K2's 2: ``row_r2_ms``, ``row_r2_device_ms``, ``row_r2_peak_bytes``, its
readings with err under ``err``; the others' 1: ``row_r1_*``; K12's at
the two-rank shard under ``shard``); K12's and K2's ``ks_grid``: their
grid form and row form at KS B 256 (phase 8(a)); a line
``[done]`` gives the whole script's seconds; the last line is {"ok":
true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

NX, HIDDEN, BATCH, DT, LR = 64, 104, 256, 0.2, 5e-3
GAMMA = 1767732205903 / 4055673282236  # ARK3(2)4L[2]SA's ESDIRK diagonal
KERNELS = {
    # name: (route, source, replaces); K2-K5 and K12 build on the ARK
    # bodies of pnode_tpu_torch/csrc/ark_tiles.cuh
    "fused_mlp_fwd": ("cuda", "pnode_tpu_torch/csrc/fused_mlp.cu",
                      "pnode_tpu/ops/fused_mlp.py:75"),
    "fused_mlp_bwd": ("cuda", "pnode_tpu_torch/csrc/fused_mlp.cu",
                      "pnode_tpu/ops/fused_mlp.py:89"),
    "fused_ark_step_fwd": ("cuda", "pnode_tpu_torch/csrc/fused_ark_forward.cu",
                           "pnode_tpu/ops/fused_ark_forward.py:53"),
    "fused_ark_step_adj": ("cuda", "pnode_tpu_torch/csrc/fused_ark_adjoint.cu",
                           "pnode_tpu/ops/fused_ark_adjoint.py:304"),
    "fused_train_loop": ("cuda", "pnode_tpu_torch/csrc/fused_train_loop.cu",
                         "pnode_tpu/ops/fused_train_loop.py:284"),
    "fused_ark_step_fwd_embedded": (
        "cuda", "pnode_tpu_torch/csrc/fused_ark_forward.cu",
        "pnode_tpu/ops/fused_ark_forward.py:53"),
    "fused_adaptive_train_loop": (
        "cuda", "pnode_tpu_torch/csrc/fused_adaptive_loop.cu",
        "pnode_tpu/ops/fused_adaptive_loop.py:262"),
    "fused_sqnxt_fwd": ("cuda", "pnode_tpu_torch/csrc/sqnxt_fwd.cu",
                        "pnode_tpu/ops/fused_sqnxt.py:192"),
    "fused_sqnxt_bwd": ("cuda", "pnode_tpu_torch/csrc/fused_sqnxt.cu",
                        "pnode_tpu/ops/fused_sqnxt.py:206"),
    "fused_sqnxt_layer_fwd": ("cuda", "pnode_tpu_torch/csrc/sqnxt_fwd.cu",
                              "pnode_tpu/ops/fused_sqnxt.py:508"),
    "fused_sqnxt_layer_bwd": ("cuda", "pnode_tpu_torch/csrc/fused_sqnxt.cu",
                              "pnode_tpu/ops/fused_sqnxt.py:522"),
    # the bf16 instances of K6-K9 (phase 12)
    "fused_sqnxt_fwd_bf16": ("cuda", "pnode_tpu_torch/csrc/sqnxt_fwd.cu",
                             "pnode_tpu/ops/fused_sqnxt.py:192"),
    "fused_sqnxt_bwd_bf16": ("cuda", "pnode_tpu_torch/csrc/fused_sqnxt.cu",
                             "pnode_tpu/ops/fused_sqnxt.py:206"),
    "fused_sqnxt_layer_fwd_bf16": ("cuda",
                                   "pnode_tpu_torch/csrc/sqnxt_fwd.cu",
                                   "pnode_tpu/ops/fused_sqnxt.py:508"),
    "fused_sqnxt_layer_bwd_bf16": ("cuda",
                                   "pnode_tpu_torch/csrc/fused_sqnxt.cu",
                                   "pnode_tpu/ops/fused_sqnxt.py:522"),
    "circular_stencil_fwd": ("cuda", "pnode_tpu_torch/csrc/circular_stencil.cu",
                             "pnode_tpu/ops/circular_stencil.py:32"),
    "circular_stencil_bwd": ("cuda", "pnode_tpu_torch/csrc/circular_stencil.cu",
                             "pnode_tpu/ops/circular_stencil.py:41"),
    "fused_grad_step": ("cuda", "pnode_tpu_torch/csrc/fused_grad_step.cu",
                        "pnode_tpu/ops/fused_train_loop.py:613"),
    "probe_smem": ("cuda", "pnode_tpu_torch/csrc/probe_smem.cu",
                   "tools/probe_vmem_limit.py:35"),
}
SQNXT_KERNELS = ("fused_sqnxt_fwd", "fused_sqnxt_bwd", "fused_sqnxt_layer_fwd",
                 "fused_sqnxt_layer_bwd")
# K6-K9 beyond the stage shapes, at the edges of their tiling:
# (label, stage whose activation is sliced (its batch repeated past B 128),
# dim, B, H, W). Ragged widths (dim 16: Cout 4), widths that are no power
# of two (dim 48: 48, 24, 12), H = 1 and W = 1 (every off-centre (3,1) or
# (1,3) tap masked), N below one column tile, and an N whose last z is
# past K6's and K8's store at the largest co-resident grid on 132 SMs
# (2,560 tiles of 256 columns: 10 a block at 264 blocks), so their last
# layer writes its anchor.
SQNXT_EDGES = (("ragged B3 5x7 dim 16", 0, 16, 3, 5, 7),
               ("dim 48 B4 8x8", 1, 48, 4, 8, 8),
               ("B5 1x9 dim 16", 0, 16, 5, 1, 9),
               ("B5 9x1 dim 16", 0, 16, 5, 9, 1),
               ("B1 3x3 dim 16", 0, 16, 1, 3, 3),
               ("B640 32x32 dim 16, last z past the store", 0, 16, 640, 32,
                32))
# and for the bf16 instances, whose store holds bf16 z tiles (twice the
# tiles of B640's at 264 blocks fit it): 20 tiles of 256 columns a block at
# the largest co-resident grid, 264 (two blocks an SM at K6's 128
# registers), past the store for the chain's last z and for K8's on the
# last layer
SQNXT_BF16_EDGES = (("B1280 32x32 dim 16, the bf16 chain's last z past its "
                     "store", 0, 16, 1280, 32, 32),)
CIFAR_B, CIFAR_LR = 128, 0.1
# phase 6(b)'s gates, kernel path against module path (PERF.md says why)
CIFAR_TOL = {"logits": 1e-3, "loss": 1e-5, "cos": 0.99, "ratio": 0.01}
# the adaptive slice's controller: bench.py's tolerances for KS, basic
ADAPT_FLAGS = ["-ts_adapt_type", "basic", "-ts_rtol", "1e-4", "-ts_atol",
               "1e-4", "-ts_adapt_max_steps", "32"]
MAX_TRIALS = 32
# phase 7, bench.py's burgers recipe (bench.py:141-200, 345-362): batch 200,
# 512-point grid, one ARK3 step of 1e-3, hpddm + frozen J + ksponly,
# ksp_rtol 1e-6, the one-step MSE, Adam at lr 5e-3
BNX, BB, BDT = 512, 200, 1e-3
BURGERS_LAYERS = [BNX * 9 // 8] * 4 + [BNX]
BURGERS_FLAGS = ["-snes_type", "ksponly", "-ksp_rtol", "1e-6"]
# K10/K11's shapes: the Burgers stage, the KS stage (both on the register
# tile), a ragged one, rows too wide to stage in 48 KB of shared memory
# (both staged, read from global memory there) and k > N (the taps wrap
# more than once; staged), then on the register tile: far more blocks than
# SMs (the dw ticket across 512 blocks), k > N with 16 rows a warp and
# lanes past the last row, an even k with a row on one lane
STENCIL_CASES = (("Burgers stage", 200, 512, 3), ("KS stage", 256, 64, 5),
                 ("ragged", 37, 100, 7), ("wide", 3, 13001, 5),
                 ("wrapped", 5, 3, 7), ("many blocks", 4096, 512, 3),
                 ("k > N on the tile", 33, 8, 9),
                 ("even k, a lane a row", 70, 4, 6))
# K10/K11's C plan against its mirror beyond STENCIL_CASES: (rows, N, k)
STENCIL_PLANS = tuple((rows, n, k) for rows in (1, 200, 4096)
                      for n in (1, 3, 64, 100, 512, 13001)
                      for k in (1, 3, 5, 7))
STENCIL_KERNELS = ("circular_stencil_fwd", "circular_stencil_bwd")


def log(msg):
    print(msg, flush=True)


def rel_err(a, b):
    """max |a - b| / max |b| over the whole tensor (b is the reference)."""
    import torch

    a = a.detach().to(torch.float64)
    b = b.detach().to(torch.float64)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def abs_err(a, b):
    import torch

    return float((a.detach().to(torch.float64)
                  - b.detach().to(torch.float64)).abs().max())


def cuda_times_ms(fn, reps=30, warmup=5, inner=10):
    """Sorted per-call times over CUDA events, after warm-up. Each sample
    times ``inner`` back-to-back calls, so a kernel's time is its device
    time once the host enqueues faster than the card runs, not the host's
    launch latency of one call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)


def summary(times):
    """(median, p66) of sorted samples: p66 is the highest percentile with
    a third of the samples beyond it (10 of 30)."""
    return statistics.median(times), times[len(times) - 1 - len(times) // 3]


# -- phase 1 and 2 ------------------------------------------------------------

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke needs an H100")
    cap = torch.cuda.get_device_capability(0)
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"compute capability {cap}; the kernels are built "
                           "for sm_90a (Hopper)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    log(smi.splitlines()[0])
    return smi.splitlines()[0]


def ptxas_report(log, source):
    """{function: [registers or None, spill store bytes, spill load bytes]}
    of every function ptxas compiled from ``source`` (a csrc file name),
    read from the build log's -Xptxas -v lines."""
    import re

    funcs, src, fn = {}, None, None
    for line in log.splitlines():
        if " -c -o " in line:  # an nvcc command: its source is last
            src = line.split()[-1].rsplit("/", 1)[-1]
            continue
        if src != source:
            continue
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$.]+)'?", line)
        if m:
            fn = m.group(1)
            funcs.setdefault(fn, [None, 0, 0])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            funcs[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            funcs[fn][0] = int(m.group(1))
    return funcs


# sources whose every function must compile without spill: K6/K8 and K7/K9
# (the bf16 tensor-core instances among them), K2, K3, K12, K4 and K5
NO_SPILL = (("sqnxt_fwd.cu", "sqnxt_fwd_kernel", "K6/K8"),
            ("fused_sqnxt.cu", "sqnxt_bwd_kernel", "K7/K9"),
            ("fused_ark_forward.cu", "ark_fwd_kernel", "K2"),
            ("fused_ark_adjoint.cu", "ark_adj_kernel", "K3"),
            ("fused_grad_step.cu", "grad_step_kernel", "K12"),
            ("fused_train_loop.cu", "train_loop_kernel", "K4"),
            ("fused_adaptive_loop.cu", "adaptive_loop_kernel", "K5"),
            ("circular_stencil.cu", "stencil_fwd_tile", "K10/K11"))
# K2's, K3's and K12's plans against their Python mirrors: (B, d, layer
# widths, stages); K3 and K12 also at the DP shards (DP_PLANS)
KS_LAYERS = [HIDDEN] * 4 + [NX]
FWD_PLANS = ((BATCH, NX, KS_LAYERS, 4), (37, NX, KS_LAYERS, 4),
             (1, NX, KS_LAYERS, 4), (3173, NX, KS_LAYERS, 4),
             (200, 512, [576] * 4 + [512], 4),
             (200, 512, [576] * 4 + [512], 8),
             (37, 13, [100, 13], 4), (37, 100, [13, 100], 4),
             (37, NX, [NX], 2), (37, NX, [24] * 7 + [NX], 6),
             (16, NX, [1100, NX], 4), (37, 200, [200, 200], 4),
             (37, 300, [300], 4), (37, 197, [201, 197], 4))
DP_PLANS = tuple((B, NX, KS_LAYERS, 4) for B in (128, 64, 32))
# the loop kernels' own edges: the odd width, d 100 at 8 stages and the
# widest d the adaptive gate opens with the KS hidden layers (134)
LOOP_PLANS = ((37, NX, [13] * 4 + [NX], 4), (37, 100, [HIDDEN] * 4 + [100], 8),
              (256, 134, [HIDDEN] * 4 + [134], 4))


# the SqueezeNext functions whose SASS must hold bf16 HMMA (the bf16
# instances: K6's and K7's chain, K8's and K9's one layer); every other
# SqueezeNext function (the fp32 instances and their out-of-line products)
# must hold none
SQNXT_TC_KERNELS = ("sqnxt_fwd_kernelI13__nv_bfloat16Li5E",
                    "sqnxt_bwd_kernelI13__nv_bfloat16Li5E",
                    "sqnxt_fwd_kernelI13__nv_bfloat16Li1E",
                    "sqnxt_bwd_kernelI13__nv_bfloat16Li1E")


def sass_hmma(lib_path):
    """{function: (HMMA instructions, of them with bf16 operands, one such
    line)} of every function in the SASS of the built library's
    SqueezeNext cubins (cuobjdump, beside nvcc: -xelf all, then -sass of
    each cubin that names sqnxt, all at once, each piped through grep so
    that only the function names and the HMMA lines reach Python)."""
    import re
    import tempfile

    from pnode_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    with tempfile.TemporaryDirectory(dir=os.path.dirname(lib_path)) as d:
        subprocess.run([tool, "-xelf", "all", lib_path], cwd=d,
                       capture_output=True, check=True)
        picked = [os.path.join(d, f) for f in sorted(os.listdir(d))
                  if f.endswith(".cubin") and b"sqnxt" in
                  open(os.path.join(d, f), "rb").read()]
        pipes = []
        for f in picked:
            dump = subprocess.Popen([tool, "-sass", f],
                                    stdout=subprocess.PIPE)
            pipes.append((dump, subprocess.Popen(
                ["grep", "-E", "Function :|HMMA"], stdin=dump.stdout,
                stdout=subprocess.PIPE, text=True)))
            dump.stdout.close()
        out = ""
        for dump, grep in pipes:
            out += grep.communicate()[0]
            if dump.wait() != 0:
                raise RuntimeError(f"cuobjdump -sass failed ({dump.args})")
    funcs, fn = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            funcs[fn] = [0, 0, ""]
        elif fn and "HMMA" in line:
            funcs[fn][0] += 1
            if "BF16" in line:
                funcs[fn][1] += 1
                funcs[fn][2] = funcs[fn][2] or line.strip()
    return funcs


def check_tensor_cores(lib_path):
    """Phase 2's tensor-core check: bf16 HMMA in every bf16 instance (K6's
    and K7's chain, K8's and K9's one layer), and no HMMA in any other
    SqueezeNext function (the fp32 instances, their out-of-line
    products)."""
    t0 = time.perf_counter()
    funcs = sass_hmma(lib_path)
    bad = []
    for fn, (n, nbf, line) in sorted(funcs.items()):
        if "sqnxt" not in fn:
            continue
        tc = any(k in fn for k in SQNXT_TC_KERNELS)
        log(f"[build] SASS {fn}: {n} HMMA, {nbf} with bf16 operands"
            f"{' (' + line + ')' if line else ''}")
        if (tc and nbf == 0) or (not tc and n):
            bad.append(fn)
    found = [k for k in SQNXT_TC_KERNELS if any(k in fn for fn in funcs)]
    if bad or len(found) != len(SQNXT_TC_KERNELS):
        raise AssertionError(f"tensor-core check: bf16 HMMA missing from, or "
                             f"HMMA found in, {bad}; bf16 kernels found "
                             f"{found}")
    log(f"[build] bf16 HMMA in the bf16 instances of K6, K7, K8 and K9, none "
        f"in any fp32 SqueezeNext function "
        f"({time.perf_counter() - t0:.1f} s)")


def start_tensor_core_check(lib_path):
    """check_tensor_cores in a thread (its time is cuobjdump's, in other
    processes): returns a function that waits for it, logs the wait and
    raises what it raised."""
    import threading

    failed = []

    def run():
        try:
            check_tensor_cores(lib_path)
        except BaseException as e:  # re-raised by the waiting function
            failed.append(e)

    worker = threading.Thread(target=run)
    worker.start()

    def wait():
        t0 = time.perf_counter()
        worker.join()
        log(f"[build] waited {time.perf_counter() - t0:.1f} s for the "
            "tensor-core check")
        if failed:
            raise failed[0]
    return wait


def sqnxt_layout_cases():
    """(label, meta) at which phase 2 holds the C plans' shared-memory
    regions against stage_layout: the three stage shapes at B 128 and
    every SQNXT_EDGES case."""
    from pnode_tpu_torch.ops import fused_sqnxt as fs

    cases = [(f"stage {i + 1}", fs.make_meta(d, CIFAR_B, h, h))
             for i, (d, h) in enumerate(((32, 32), (64, 16), (128, 8)))]
    return cases + [(e[0], fs.make_meta(e[2], e[3], e[4], e[5]))
                    for e in SQNXT_EDGES + SQNXT_BF16_EDGES]


def grid_phase_cases():
    """(B, d, layer widths, tableau) at which phase 2 holds the grid form's
    phases against their mirror: Burgers-512 (ARK3, the 8-stage ARK 5),
    d 200, rows of 197 and 201 floats, one layer (ARK3, ARK 4), and a
    tableau whose explicit stage is stage 1 (its G from the workspace), at
    one and two layers."""
    from pnode_tpu_torch.tableaus import get_ark_tableau

    def tab(name):
        t = get_ark_tableau(name)
        return ([[float(x) for x in r] for r in t.a_im],
                [[float(x) for x in r] for r in t.a_ex],
                [float(x) for x in t.b_im], [float(x) for x in t.b_ex])

    late = ([[0.5, 0.0, 0.0], [0.25, 0.0, 0.0], [0.25, 0.25, 0.5]],
            [[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.25, 0.5, 0.0]],
            [0.25, 0.25, 0.5], [0.25, 0.5, 0.25])
    return ((BB, BNX, BURGERS_LAYERS, tab("3")),
            (BB, BNX, BURGERS_LAYERS, tab("5")),
            (37, 200, [200, 200], tab("3")), (37, 197, [201, 197], tab("3")),
            (37, 300, [300], tab("3")), (9, 300, [300], tab("4")),
            (37, 300, [300], late), (9, 200, [200, 200], late))


def phase_build():
    import torch

    from pnode_tpu_torch.ops import _build
    from pnode_tpu_torch.ops import circular_stencil as stencil
    from pnode_tpu_torch.ops import fused_ark_adjoint as adj
    from pnode_tpu_torch.ops import fused_adaptive_loop as adapt
    from pnode_tpu_torch.ops import fused_ark_forward as fwd
    from pnode_tpu_torch.ops import fused_sqnxt as fs
    from pnode_tpu_torch.ops import fused_train_loop as loop

    t0 = time.perf_counter()
    lib = _build.library()
    secs = time.perf_counter() - t0
    info = _build.build_info
    tensor_cores = start_tensor_core_check(info["path"])
    log(f"[build] {info['path']} in {secs:.1f} s "
        f"({'cached' if info.get('cached') else 'nvcc'})")
    build_log = info.get("log") or (_build.BUILD_DIR / "build.log").read_text()
    for line in build_log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            log(f"[build]   {line.strip()}")
    # every function ptxas compiled from these sources, the kernels and
    # their out-of-line functions, without spill
    for source, kernel, name in NO_SPILL:
        funcs = ptxas_report(build_log, source)
        for fn, (regs, st, ld) in sorted(funcs.items()):
            log(f"[build] {source} {fn}: {regs} registers, spill stores "
                f"{st} B, spill loads {ld} B")
        if not any(kernel in fn for fn in funcs) or any(
                st or ld for _, st, ld in funcs.values()):
            raise AssertionError(f"{name}: ptxas reports spill in "
                                 f"csrc/{source} (or no kernel there)")
    # K2's, K3's, K12's, K4's and K5's plans (rows per block, grid, bytes;
    # K5's workspace floats) against their mirrors
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda", 0)
    for name, shapes, c_plan, mirror in (
            ("K2", FWD_PLANS, fwd.plan, adj.ark_fwd_plan),
            ("K3", FWD_PLANS + DP_PLANS, adj.plan, adj.ark_adj_plan),
            ("K12", FWD_PLANS + DP_PLANS,
             lambda *a: adj.plan(*a, grad=True), adj.grad_step_plan),
            ("K4", FWD_PLANS + DP_PLANS + LOOP_PLANS, loop.plan,
             loop.train_loop_plan),
            ("K5", FWD_PLANS + LOOP_PLANS,
             lambda B, d, l, s, dev: adapt.plan(B, d, l, s, MAX_TRIALS, dev),
             lambda B, d, l, s, sms: adapt.adaptive_loop_plan(
                 B, d, l, s, MAX_TRIALS, sms))):
        for B, d, layers, s in shapes:
            got = c_plan(B, d, layers, s, dev)
            want = mirror(B, d, layers, s, sms)
            log(f"[build] {name}'s plan at B {B}, {[d] + layers}, s {s}: "
                f"{got} (mirror {want}; {sms} SMs)")
            if got != want:
                raise AssertionError(f"{name}'s plan disagrees with its "
                                     "mirror")
    # the grid form's plans (grid, bytes, workspace floats) of its four
    # kinds at the shapes where K3's plan takes it
    for B, d, layers, s in FWD_PLANS:
        plan = adj.ark_adj_plan(B, d, layers, s, sms)
        if plan is None or plan[0] != 0:
            continue
        for kind in adj.GRID_KINDS:
            got = adj.c_grid_plan(kind, B, d, layers, s, dev)
            want = adj.grid_plan(kind, B, d, layers, s, sms)
            log(f"[build] grid form {kind}'s plan at B {B}, {[d] + layers}, "
                f"s {s}: {got} (mirror {want})")
            if got != want:
                raise AssertionError("the grid form's plan disagrees with "
                                     "its mirror")
    # the grid form's phases: the C generator's products (next_phase, run
    # on the host) against the mirror's, whose reads and writes the tests
    # check phase by phase
    n = 0
    for B, d, layers, tab in grid_phase_cases():
        for kind, k in ((adj.GRID_STEP, 0), (adj.GRID_LOOP, 0),
                        (adj.GRID_LOOP, 1), (adj.GRID_GRAD, 0),
                        (adj.GRID_FWD, 0)):
            got = adj.c_grid_phases(kind, B, d, layers, tab, k)
            if got != adj.grid_phases(kind, B, d, layers, tab, k):
                raise AssertionError(
                    f"the grid form's phases at B {B}, {[d] + layers}, "
                    f"{len(tab[2])} stages, kind {kind}, k {k} differ from "
                    "their mirror's")
            n += sum(len(ph["products"]) for ph in got)
    log(f"[build] grid form's phases equal their mirror's at "
        f"{len(grid_phase_cases())} shapes, all four kinds: K3's step, K4's "
        f"first and later iterations, K12's gradient step and K2's forward "
        f"step ({n} products)")
    # the loop kernels at forced rows: each R's C plan against its mirror
    for B, hidden in ((BATCH, HIDDEN), (37, 13), (strided_batch(), 24)):
        layers = [hidden] * 4 + [NX]
        for r in (1, 2, 4, 8):
            for name, got, want in (
                    ("K4", loop.plan(B, NX, layers, 4, dev, rows=r),
                     loop.train_loop_plan(B, NX, layers, 4, sms, rows=r)),
                    ("K5", adapt.plan(B, NX, layers, 4, MAX_TRIALS, dev,
                                      rows=r),
                     adapt.adaptive_loop_plan(B, NX, layers, 4, MAX_TRIALS,
                                              sms, rows=r))):
                if got != want:
                    raise AssertionError(
                        f"{name}'s plan at B {B}, hidden {hidden}, R {r}: "
                        f"{got}, mirror {want}")
        log(f"[build] K4's and K5's plans at B {B}, hidden {hidden}, R 1, 2, "
            f"4, 8 equal their mirrors")
    # K10/K11's plan (body, rows per warp, rows per block, grid)
    shapes = [c[1:] for c in STENCIL_CASES] + list(STENCIL_PLANS)
    for rows, n, k in shapes:
        for aligned in (True, False):
            for need_dw in (False, True):
                got = stencil.plan(rows, n, k, dev, aligned, need_dw)
                want = stencil.stencil_plan(rows, n, k, sms, aligned,
                                            need_dw)
                if got != want:
                    raise AssertionError(
                        f"K10/K11's plan at ({rows}, {n}), k {k}, aligned "
                        f"{aligned}, dw {need_dw}: {got}, mirror {want}")
    for label, rows, n, k in STENCIL_CASES:
        log(f"[build] K10/K11's plan at the {label} shape ({rows}, {n}), k "
            f"{k}: {stencil.plan(rows, n, k, dev)}, with dw "
            f"{stencil.plan(rows, n, k, dev, need_dw=True)} (body, rows per "
            "warp, rows per block, grid)")
    log(f"[build] K10/K11's plans at {4 * len(shapes)} shapes and modes "
        "equal their mirrors")
    # K6-K9's staged tile and weights (floats), both dtypes, chain and each
    # layer alone, forward and backward: the C plans against stage_layout
    n = 0
    for label, meta in sqnxt_layout_cases():
        for lis in [list(range(5))] + [[li] for li in range(5)]:
            for esize in (4, 2):
                for backward in (False, True):
                    got = fs.c_stage_layout(meta, lis, dev, esize, backward)
                    want = fs.stage_layout(meta, lis, esize, backward)
                    if got != want:
                        raise AssertionError(
                            f"K6-K9's layout at {label}, layers {lis}, esize "
                            f"{esize}, backward {backward}: C {got}, mirror "
                            f"{want}")
                    n += 1
        for esize in (4, 2):
            log(f"[build] K6/K7 at {label}, esize {esize}: tile and weight "
                f"floats forward {fs.stage_layout(meta, range(5), esize)}, "
                f"backward {fs.stage_layout(meta, range(5), esize, True)}")
    log(f"[build] K6-K9's shared-memory regions at {n} shapes, modes and "
        "dtypes equal their mirror")
    return tensor_cores


def phase_probe():
    """Phase 2's probe (path B): K13 up its ladder and bisected to the
    largest working dynamic shared memory per block, which must equal the
    port's MAX_SMEM_BYTES and the card's opt-in attribute; then K13 at that
    size against its plain version (bitwise) and timed beside it and
    torch.mul(x, 3). Returns K13's report, launches included."""
    import torch

    from pnode_tpu_torch.ops.fused_ark_adjoint import MAX_SMEM_BYTES
    from pnode_tpu_torch.tools import probe_smem_limit as probe

    probe.probe_smem.launches = 0
    res = probe.main([])
    launches = probe.probe_smem.launches
    log(f"[probe] largest {res['largest']} B, opt-in attribute "
        f"{res['optin']} B, MAX_SMEM_BYTES {MAX_SMEM_BYTES} B; "
        f"{launches} launches")
    if not res["largest"] == res["optin"] == MAX_SMEM_BYTES:
        raise AssertionError(
            f"the probe's largest working size ({res['largest']} B), the "
            f"card's opt-in attribute ({res['optin']} B) and the gates' "
            f"MAX_SMEM_BYTES ({MAX_SMEM_BYTES} B) differ")
    n = res["largest"]
    x = probe.probe_input(n, "cuda")
    got = probe.probe_smem(x, n)
    torch.cuda.synchronize()
    err = abs_err(got, probe.probe_smem_plain(x))
    if not torch.equal(got, probe.probe_smem_plain(x)):
        raise AssertionError(f"probe_smem disagrees with 3x ({err:.3e})")
    probe_edges(n)
    fns = (lambda: probe.probe_smem_plain(x), lambda: probe.probe_smem(x, n),
           lambda: torch.mul(x, 3))
    t = [summary(cuda_times_ms(fns[i]))[0] for i in (0, 1, 2, 1, 0, 2)]
    # the profiler's device time of K13 and of torch.mul's kernel: CUDA
    # events time what a caller of back-to-back calls waits for, which may
    # be the host's side of the call
    dev_k13, n_k13 = device_us_per_call(fns[1], ["probe_smem_kernel"])
    dev_mul, n_mul = device_us_per_call(fns[2], [""])
    report = dict(max_abs_err=err, ms=min(t[1], t[3]),
                  plain_ms=min(t[0], t[4]), library_ms=min(t[2], t[5]),
                  launches=launches, device_ms=dev_k13 / 1e3,
                  library_device_ms=dev_mul / 1e3)
    report["bound_ms"], report["bound_by"] = bound(2 * x.numel(),
                                                   8 * x.numel())
    log(f"[probe] K13 at {n} B x {x.numel()} floats: kernel {t[1]:.4f} / "
        f"{t[3]:.4f} ms (device {dev_k13 / 1e3:.4f} ms, {n_k13} launches "
        f"traced), plain {t[0]:.4f} / {t[4]:.4f} ms, torch.mul "
        f"{t[2]:.4f} / {t[5]:.4f} ms (device {dev_mul / 1e3:.4f} ms, "
        f"{n_mul} launches traced); bound {report['bound_ms']:.5f} ms "
        f"({report['bound_by']}); bitwise equal to 3x")
    return report


def probe_edges(largest):
    """K13 where its bulk copies do not reach: sizes that are no multiple
    of 16 B (the opt-in less 4 B, 100 B, 4 KB + 12 B), a ragged n, x 4-12
    B past a 16-byte boundary (each tile's slots rotate, and out, a fresh
    allocation, is aligned otherwise than x: scalar stores), bitwise
    against 3x, each call repeated bitwise."""
    import torch

    from pnode_tpu_torch.tools import probe_smem_limit as probe

    gen = torch.Generator(device="cuda").manual_seed(1)
    for nbytes, n, off in ((largest, 3 * (largest // 4) + 5, 0),
                           (largest - 4, 2 * (largest // 4) + 7, 1),
                           (100, 1001, 3), (4096 + 12, 9999, 2),
                           (largest, 132 * (largest // 4), 2)):
        x = torch.randn(n + 4, generator=gen, device="cuda")[off:off + n]
        got = probe.probe_smem(x, nbytes)
        again = probe.probe_smem(x, nbytes)
        torch.cuda.synchronize()
        ok = torch.equal(got, 3.0 * x) and torch.equal(got, again)
        log(f"[probe] K13 edge at {nbytes} B, n {n}, x {4 * off} B past "
            f"16-byte alignment: "
            f"{'bitwise 3x, repeat equal' if ok else 'WRONG'}")
        if not ok:
            raise AssertionError(f"probe_smem at {nbytes} B, n {n}, offset "
                                 f"{off} disagrees with 3x")


# -- phase 3 ------------------------------------------------------------------

def ks_operators(device, B=BATCH, nx=NX):
    """Frozen J, the ARK3 stage inverse at DT and the tableau from the
    port's own KSFuncIM, and the prepared stepper (its embedded weights,
    the spectral basis of J, the per-trial stage inverses)."""
    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.models import KSFuncEX, KSFuncIM

    pt.clear_options()
    pt.init(["chip_smoke", "-snes_type", "ksponly"])
    im = KSFuncIM(nx=nx, device=device)
    ex = KSFuncEX(nx=nx, hidden=8, use_fused=True,
                  generator=torch.Generator(device=device).manual_seed(0),
                  device=device)
    ode = pt.ODESolver()
    y = torch.zeros(B, nx, device=device)
    ode.setupTS(y, pt.TorchFunc(im), step_size=DT, method="imex",
                imex_form=True, func2=pt.TorchFunc(ex),
                linear_solver="hpddm", fixed_jacobian=True, batch_size=B)
    stp = ode._stepper.prepare(0.0, y, ({}, {}), dt0=DT)
    J = stp.setup.frozen_J_blocks[0]
    inv = stp.setup.solver_cache[GAMMA]._inv[0]
    return J, inv, ode._stepper._tableau_static(), stp


def make_stack(device, rng, hidden, nonzero_bias):
    """MLP stack 64 -> hidden x4 -> 64: N(0, 0.01) weights and zero biases
    (the KS init), or N(0, 0.2) weights and N(0, 0.1) biases."""
    import torch

    dims = [NX] + [hidden] * 4 + [NX]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    Ws = [f32(rng.normal(0.0, 0.01 if not nonzero_bias else 0.2,
                         size=(a, b))) for a, b in zip(dims, dims[1:])]
    bs = [f32(rng.normal(0.0, 0.1, size=(b,)) if nonzero_bias
              else np.zeros(b)) for b in dims[1:]]
    return Ws, bs


def make_case(device, u, B, hidden, nonzero_bias, seed):
    """MLP stack, states x (B rows of the KS data u), and random covectors
    g (K1 backward) and lam (K3)."""
    import torch

    rng = np.random.default_rng(seed)
    Ws, bs = make_stack(device, rng, hidden, nonzero_bias)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    x = f32(u[rng.choice(len(u), B, replace=False)])
    g = f32(rng.normal(size=(B, NX)))
    lam = f32(rng.normal(size=(B, NX)))
    return Ws, bs, x, g, lam


def check_kernel(name, got, plain, ref64, tol32, report, tol64=1e-4):
    """got/plain/ref64: lists of tensors; records and asserts the errors:
    within ``tol32`` of the plain fp32 version and within ``tol64`` of the
    plain version in float64. The plain fp32 version's own error against
    float64 is printed beside them."""
    e32 = max(rel_err(a, b) for a, b in zip(got, plain))
    e64 = max(rel_err(a, b) for a, b in zip(got, ref64))
    e_plain = max(rel_err(a, b) for a, b in zip(plain, ref64))
    ea = max(abs_err(a, b) for a, b in zip(got, plain))
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), ea)
    ok = e32 <= tol32 and e64 <= tol64
    log(f"[kernels]   {name}: rel err vs plain fp32 {e32:.3e} (tol "
        f"{tol32:.0e}), vs plain fp64 {e64:.3e} (tol {tol64:.0e}; plain fp32 "
        f"vs fp64 {e_plain:.3e}), max abs {ea:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")


def phase_kernels(device, u):
    import torch

    from pnode_tpu_torch.ops.fused_ark_adjoint import (
        fused_ark_step_adj, fused_ark_step_adj_plain)
    from pnode_tpu_torch.ops.fused_ark_forward import (
        fused_ark_step_fwd, fused_ark_step_fwd_embedded,
        fused_ark_step_fwd_plain)
    from pnode_tpu_torch.ops.fused_mlp import (
        fused_mlp_bwd, fused_mlp_bwd_plain, fused_mlp_fwd, fused_mlp_plain)

    J, inv, tab, stp = ks_operators(device)
    berr = (stp._bIe, stp._bEe)
    dt = float(np.float32(DT))  # the step size as the fp32 solve carries it
    f64 = lambda ts: [t.to(torch.float64) for t in ts]  # noqa: E731
    reports = {k: {} for k in KERNELS}
    cases = [("main path B256 h104", BATCH, HIDDEN, False, 1),
             ("ragged B37 h24 biased", 37, 24, True, 2)]
    for label, B, hidden, biased, seed in cases:
        log(f"[kernels] {label}")
        Ws, bs, x, g, lam = make_case(device, u, B, hidden, biased, seed)
        main = B == BATCH
        # K1 forward
        out = fused_mlp_fwd(x, Ws, bs)
        torch.cuda.synchronize()
        check_kernel("fused_mlp_fwd", [out], [fused_mlp_plain(x, Ws, bs)],
                     [fused_mlp_plain(x.double(), f64(Ws), f64(bs))], 1e-5,
                     reports["fused_mlp_fwd"] if main else {})
        # K1 backward
        got = fused_mlp_bwd(x, g, Ws, bs)
        torch.cuda.synchronize()
        pl = fused_mlp_bwd_plain(x, g, Ws, bs)
        r64 = fused_mlp_bwd_plain(x.double(), g.double(), f64(Ws), f64(bs))
        flat = lambda r: [r[0], *r[1], *r[2]]  # noqa: E731
        check_kernel("fused_mlp_bwd", flat(got), flat(pl), flat(r64), 1e-4,
                     reports["fused_mlp_bwd"] if main else {})
        check_k1_repeat(label, x, g, Ws, bs, got)
        # K2
        args = (tab, dt, x, J, inv, Ws, bs)
        args64 = (tab, dt, x.double(), J.double(), inv.double(), f64(Ws),
                  f64(bs))
        y1, Ys = fused_ark_step_fwd(*args)
        torch.cuda.synchronize()
        y1p, Ysp = fused_ark_step_fwd_plain(*args)
        y1d, Ysd = fused_ark_step_fwd_plain(*args64)
        check_kernel("fused_ark_step_fwd", [y1, Ys], [y1p, Ysp], [y1d, Ysd],
                     1e-5, reports["fused_ark_step_fwd"] if main else {})
        # K2 with its embedded error output (the adaptive trial step)
        check_embedded(tab, berr, dt, x, J, inv, Ws, bs, args64,
                       reports["fused_ark_step_fwd_embedded"] if main else {})
        # the same at a trial's dt and spectral stage inverse (reading only:
        # err is ~50x smaller at dt 0.05 than at 0.2, the rounding is not)
        dtt = float(np.float32(0.05))
        invt = stp._trial_inverse(J, GAMMA, dtt)
        e_k = fused_ark_step_fwd_embedded(tab, berr, dtt, x, J, invt, Ws,
                                          bs)[1]
        e_p = fused_ark_step_fwd_plain(tab, dtt, x, J, invt, Ws, bs,
                                       b_err=berr)[1]
        e_d = fused_ark_step_fwd_plain(tab, dtt, x.double(), J.double(),
                                       invt.double(), f64(Ws), f64(bs),
                                       b_err=berr)[1]
        log(f"[kernels]   fused_ark_step_fwd_embedded at dt {dtt}: err rel "
            f"(to max |err| {float(e_p.abs().max()):.3e}) vs plain fp32 "
            f"{rel_err(e_k, e_p):.3e}, vs plain fp64 {rel_err(e_k, e_d):.3e} "
            f"(plain fp32 vs fp64 {rel_err(e_p, e_d):.3e}); not gated")
        # K3, on the plain forward's stage values
        aargs = (tab, dt, Ysp, lam, J, inv, Ws, bs)
        aargs64 = (tab, dt, Ysp.double(), lam.double(), J.double(),
                   inv.double(), f64(Ws), f64(bs))
        flat3 = lambda r: [r[0], *r[1][0], *r[1][1]]  # noqa: E731
        got = fused_ark_step_adj(*aargs)
        torch.cuda.synchronize()
        check_kernel("fused_ark_step_adj", flat3(got),
                     flat3(fused_ark_step_adj_plain(*aargs)),
                     flat3(fused_ark_step_adj_plain(*aargs64)), 1e-4,
                     reports["fused_ark_step_adj"] if main else {})
        if main:
            timings = {
                "fused_mlp_fwd": (lambda: fused_mlp_fwd(x, Ws, bs),
                                  lambda: fused_mlp_plain(x, Ws, bs)),
                "fused_mlp_bwd": (lambda: fused_mlp_bwd(x, g, Ws, bs),
                                  lambda: fused_mlp_bwd_plain(x, g, Ws, bs)),
                "fused_ark_step_fwd": (
                    lambda: fused_ark_step_fwd(*args),
                    lambda: fused_ark_step_fwd_plain(*args)),
                "fused_ark_step_fwd_embedded": (
                    lambda: fused_ark_step_fwd_embedded(tab, berr, *args[1:]),
                    lambda: fused_ark_step_fwd_plain(*args, b_err=berr)),
                "fused_ark_step_adj": (
                    lambda: fused_ark_step_adj(*aargs),
                    lambda: fused_ark_step_adj_plain(*aargs)),
            }
            for name, (kern, plain) in timings.items():
                # plain, kernel, kernel, plain: compare within one call
                p1 = summary(cuda_times_ms(plain))
                k1 = summary(cuda_times_ms(kern))
                k2 = summary(cuda_times_ms(kern))
                p2 = summary(cuda_times_ms(plain))
                reports[name]["ms"] = min(k1[0], k2[0])
                reports[name]["plain_ms"] = min(p1[0], p2[0])
                log(f"[kernels]   {name}: kernel median {k1[0]:.4f} / "
                    f"{k2[0]:.4f} ms (p66 {k1[1]:.4f} / {k2[1]:.4f}), plain "
                    f"median {p1[0]:.4f} / {p2[0]:.4f} ms (p66 {p1[1]:.4f} / "
                    f"{p2[1]:.4f}); 30 samples of 10 back-to-back calls")
            # the profiler's device time of K2 (with and without err) and
            # of K3 (its step kernel and its block-order sum of partials)
            for name, parts in (
                    ("fused_ark_step_fwd", ["ark_fwd_kernel"]),
                    ("fused_ark_step_fwd_embedded", ["ark_fwd_kernel"]),
                    ("fused_ark_step_adj", ["ark_adj_kernel",
                                            "sum_partials_kernel"])):
                us, traced = device_us_per_call(timings[name][0], parts)
                reports[name]["device_ms"] = us / 1e3
                log(f"[kernels]   {name}: device {us:.2f} us per call "
                    f"({traced} launches traced)")
            log(f"[kernels]   fused_ark_step_adj: {partial_bytes(B, HIDDEN)}")
    phase_k1_edges(device, u)
    phase_k2_edges(device, u)
    phase_k3_edges(device, u)
    reports["fused_train_loop"] = phase_loop_kernel(device, u, J, inv, tab,
                                                    dt)
    for name, r in phase_burgers_kernels(device).items():
        reports[name]["burgers"] = r
    reports["fused_adaptive_train_loop"] = phase_adaptive_kernel(device, u,
                                                                 stp)
    return reports


# K1 at the edges of its 32 x 32 tiling: one row, a ragged row tile,
# widths no multiple of a tile, the shortest and the longest stack, tanh
K1_EDGES = (("B 1", 1, [NX] + [HIDDEN] * 4 + [NX], "relu"),
            ("B 37", 37, [NX] + [HIDDEN] * 4 + [NX], "relu"),
            ("widths 13 and 100", 37, [13, 100, 13, 100, 13], "relu"),
            ("1 layer", 37, [100, 13], "relu"),
            ("8 layers", 37, [NX] + [24] * 7 + [NX], "relu"),
            ("tanh", BATCH, [NX] + [HIDDEN] * 4 + [NX], "tanh"))


def check_k1_repeat(label, x, g, Ws, bs, got, act="relu"):
    """A second K1 backward on the same inputs must equal ``got`` bitwise:
    one thread sums each dW/db element over the rows in a fixed order."""
    import torch

    from pnode_tpu_torch.ops.fused_mlp import fused_mlp_bwd

    again = fused_mlp_bwd(x, g, Ws, bs, act)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(
        [got[0], *got[1], *got[2]], [again[0], *again[1], *again[2]]))
    log(f"[kernels]   fused_mlp_bwd {label}: a second call "
        f"{'equals' if same else 'DIFFERS FROM'} the first bitwise")
    if not same:
        raise AssertionError("K1's backward is not deterministic")


def phase_k1_edges(device, u):
    """Phase 3's K1 edge cases (K1_EDGES) against the plain versions in fp32
    and fp64 with phase 3's gates (forward 1e-5, backward 1e-4 of max |ref|;
    1e-4 against fp64), weights N(0, 1 / fan_in), biases N(0, 0.1), KS
    states where the input width is the grid's, else N(0, 1); each backward
    repeated bitwise; then scratch one float short of what the C entry
    point computes must be refused."""
    import torch

    from pnode_tpu_torch.ops import _build
    from pnode_tpu_torch.ops.fused_mlp import (
        _ACT_CODES, fused_mlp_bwd, fused_mlp_bwd_plain, fused_mlp_fwd,
        fused_mlp_plain, mlp_scratch)

    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    f64 = lambda ts: [t.to(torch.float64) for t in ts]  # noqa: E731
    flat = lambda r: [r[0], *r[1], *r[2]]  # noqa: E731
    for i, (label, B, dims, act) in enumerate(K1_EDGES):
        rng = np.random.default_rng(100 + i)
        Ws = [f32(rng.normal(0.0, a ** -0.5, size=(a, b)))
              for a, b in zip(dims, dims[1:])]
        bs = [f32(rng.normal(0.0, 0.1, size=b)) for b in dims[1:]]
        x = f32(u[rng.choice(len(u), B, replace=False)] if dims[0] == NX
                else rng.normal(size=(B, dims[0])))
        g = f32(rng.normal(size=(B, dims[-1])))
        log(f"[kernels] K1 edge: {label} (B {B}, {dims}, {act})")
        out = fused_mlp_fwd(x, Ws, bs, act)
        torch.cuda.synchronize()
        check_kernel("fused_mlp_fwd", [out], [fused_mlp_plain(x, Ws, bs, act)],
                     [fused_mlp_plain(x.double(), f64(Ws), f64(bs), act)],
                     1e-5, {})
        got = fused_mlp_bwd(x, g, Ws, bs, act)
        torch.cuda.synchronize()
        check_kernel("fused_mlp_bwd", flat(got),
                     flat(fused_mlp_bwd_plain(x, g, Ws, bs, act)),
                     flat(fused_mlp_bwd_plain(x.double(), g.double(), f64(Ws),
                                              f64(bs), act)), 1e-4, {})
        check_k1_repeat(label, x, g, Ws, bs, got, act)
    # the C entry point computes the scratch it needs and refuses a size
    # that differs (the last case's operands, one float short)
    lib = _build.library()
    size = mlp_scratch(tuple(dims), B)[0]
    out = torch.empty(B, dims[-1], device=device)
    scratch = torch.empty(size, device=device)
    rc = lib.pnode_mlp_fwd(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                           size - 1, B, len(Ws), _build.int_array(dims),
                           _build.ptr_array(Ws), _build.ptr_array(bs),
                           _ACT_CODES[act], _build.stream_of(x))
    log(f"[kernels] K1 given scratch one float short: rc {rc} "
        f"({lib.pnode_error_string(rc).decode() if rc else 'accepted'})")
    if rc != 1:  # cudaErrorInvalidValue
        raise AssertionError("K1 took scratch of another size than its own")


# K2 at the edges of its plan and tiling: (label, B, dims, activation,
# tableau). One row; a ragged last block; a grid of 397 blocks of 8 rows;
# widths 13 and 100 (no multiple of the 4-column register tile, k split
# into 25 groups); 1 and 8 layers; tanh; 2, 6 and 8 stages; the Burgers
# forward at d 512, whose operators and weights stream through the ring.
K2_EDGES = (("B 1", 1, [NX] + [HIDDEN] * 4 + [NX], "relu", "3"),
            ("B 37", 37, [NX] + [HIDDEN] * 4 + [NX], "relu", "3"),
            ("B 3173", 3173, [NX] + [HIDDEN] * 4 + [NX], "relu", "3"),
            ("width 13", 37, [13, 100, 13], "relu", "3"),
            ("width 100", 37, [100, 13, 100], "relu", "3"),
            ("1 layer", 37, [NX, NX], "relu", "3"),
            ("8 layers", 37, [NX] + [24] * 7 + [NX], "relu", "3"),
            ("tanh", BATCH, [NX] + [HIDDEN] * 4 + [NX], "tanh", "3"),
            ("2 stages", 37, [NX] + [HIDDEN] * 4 + [NX], "relu", "1bee"),
            ("6 stages", 37, [NX] + [HIDDEN] * 4 + [NX], "relu", "4"),
            ("8 stages", 37, [NX] + [HIDDEN] * 4 + [NX], "relu", "5"),
            ("Burgers d 512", BB, [BNX] + [576] * 4 + [BNX], "relu", "3"))


def phase_k2_edges(device, u):
    """Phase 3's K2 edge cases (K2_EDGES), each without and with the
    embedded error output, against the plain versions in fp32 and fp64:
    y1 and Ys within 1e-5 of max |ref| of the plain fp32 version and 1e-4
    of the fp64 one; err within max(1e-4, 3 e) of both, e being the plain
    fp32 version's own distance from fp64 (err is a small difference of
    stage sums: check_embedded says why). Each call repeated bitwise.
    The operators: J and the stage inverse of the KS main path at d 64,
    ARK3, dt 0.2; else J = -2 A A^T / d (A ~ N(0, 1)) and inv = (I - dt
    gamma J)^{-1} formed in float64, gamma the tableau's first nonzero
    diagonal coefficient. States: KS data at d 64 (drawn with replacement
    past its 600 samples), N(0, 1) elsewhere; weights N(0, 1 / fan_in),
    biases N(0, 0.1)."""
    import torch

    from pnode_tpu_torch.ops.fused_ark_forward import (
        fused_ark_step_fwd, fused_ark_step_fwd_embedded,
        fused_ark_step_fwd_plain)
    from pnode_tpu_torch.tableaus import get_ark_tableau

    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    f64 = lambda ts: [t.to(torch.float64) for t in ts]  # noqa: E731
    J_ks, inv_ks, tab_ks, _ = ks_operators(device)
    dt = float(np.float32(DT))
    for i, (label, B, dims, act, tname) in enumerate(K2_EDGES):
        rng = np.random.default_rng(200 + i)
        d = dims[0]
        t = get_ark_tableau(tname)
        tab = ([[float(x) for x in r] for r in t.a_im],
               [[float(x) for x in r] for r in t.a_ex],
               [float(x) for x in t.b_im], [float(x) for x in t.b_ex])
        berr = ([float(x) for x in t.b_im_err],
                [float(x) for x in t.b_ex_err])
        if d == NX and tname == "3":
            J, inv, tab = J_ks, inv_ks, tab_ks
        else:
            A = rng.normal(size=(d, d))
            J64 = -2.0 * (A @ A.T) / d
            gamma = [g for g in np.diag(t.a_im) if g != 0.0][0]
            J = f32(J64)
            inv = f32(np.linalg.inv(np.eye(d) - dt * gamma * J64))
        Ws = [f32(rng.normal(0.0, a ** -0.5, size=(a, b)))
              for a, b in zip(dims, dims[1:])]
        bs = [f32(rng.normal(0.0, 0.1, size=b)) for b in dims[1:]]
        x = f32(u[rng.choice(len(u), B, replace=B > len(u))] if d == NX
                else rng.normal(size=(B, d)))
        args = (tab, dt, x, J, inv, Ws, bs, act)
        args64 = (tab, dt, x.double(), J.double(), inv.double(), f64(Ws),
                  f64(bs), act)
        log(f"[kernels] K2 edge: {label} (B {B}, {dims}, {act}, ARK "
            f"{tname}, {len(tab[2])} stages)")
        got = fused_ark_step_fwd(*args)
        again = fused_ark_step_fwd(*args)
        torch.cuda.synchronize()
        check_kernel("fused_ark_step_fwd", list(got),
                     list(fused_ark_step_fwd_plain(*args)),
                     list(fused_ark_step_fwd_plain(*args64)), 1e-5, {})
        y1, e, Ys = fused_ark_step_fwd_embedded(tab, berr, *args[1:])
        again_e = fused_ark_step_fwd_embedded(tab, berr, *args[1:])
        torch.cuda.synchronize()
        p = fused_ark_step_fwd_plain(*args, b_err=berr)
        r = fused_ark_step_fwd_plain(*args64, b_err=berr)
        check_kernel("fused_ark_step_fwd_embedded (y1, Ys)", [y1, Ys],
                     [p[0], p[2]], [r[0], r[2]], 1e-5, {})
        tol = max(1e-4, 3.0 * rel_err(p[1], r[1]))
        check_kernel("fused_ark_step_fwd_embedded (err)", [e], [p[1]], [r[1]],
                     tol, {}, tol64=tol)
        same = all(torch.equal(a, b) for a, b in
                   zip(list(got) + [y1, e, Ys], list(again) + list(again_e)))
        log(f"[kernels]   K2 {label}: a second call of each "
            f"{'equals' if same else 'DIFFERS FROM'} the first bitwise")
        if not same:
            raise AssertionError("K2 is not deterministic")


# K3 at the edges of its plan and tiling: K2_EDGES (the Burgers reverse
# at d 512, B 200 on the port's own BurgersFuncIM operators at dt 1e-3:
# the grid form, and forced R 1 and 2 reading inv and J in place), three
# 1024-wide layers at
# 8 stages, where no R holds every stage's layer store (the plan keeps 7
# stage slots at one row, so dW/db are flushed twice, and the weights
# stream in chunks), and d 200 and 300, where inv and J do not fit in
# shared memory (the plan takes the grid form; the row form reads them in
# place, at d 300 in two column blocks), and d 197 with a 201-wide layer,
# where the grid form's rows are not 16-byte aligned (its 4-byte loads,
# the ones row of dW/db); every case at the plan's form and at each forced
# R that fits
K3_EDGES = K2_EDGES + (
    ("store flushed twice", 5, [NX, 1024, 1024, 1024, NX], "relu", "5"),
    ("inv, J in place d 200", 37, [200, 200, 200], "relu", "3"),
    ("inv, J in place d 300", 37, [300, 300], "relu", "3"),
    ("grid form, ragged d 197", 37, [197, 201, 197], "relu", "3"))


def partial_bytes(B, hidden, grad=False):
    """K3's (or K12's) partials at the KS widths and batch B: the plan's
    grid, and the bytes the blocks write and the block-order sum reads back
    (fp32), beside the kernel's time (not in its bound)."""
    from pnode_tpu_torch.ops.fused_ark_adjoint import (ark_adj_plan,
                                                       grad_step_plan)

    dims = [NX] + [hidden] * 4 + [NX]
    plan = (grad_step_plan if grad else ark_adj_plan)(B, NX, dims[1:], 4)
    per = sum(a * b + b for a, b in zip(dims, dims[1:]))
    if grad:  # and the loss, in a slice rounded up to 16 bytes
        per = -(-(per + 1) // 4) * 4
    return (f"plan {plan} (rows, grid, B); partials {plan[1]} x {per} floats"
            f": {4 * plan[1] * per} B written, the same read back by the sum")


def relu_flips(Ys, Ws, bs):
    """(count, largest fp64 |z|) of the ReLU decisions on which K3's
    recompute (``reverse_relu_masks``, the kernel's summation order) and
    the plain version's cuBLAS products part, over the stage values Ys:
    a unit within fp32 rounding of 0 goes either way in two correct fp32
    evaluations (phase_burgers_mlp), and moves the reverse's gradients by
    ~1e-3; an |z| far above rounding would be an error."""
    import torch

    from pnode_tpu_torch.ops.fused_ark_adjoint import reverse_relu_masks

    kernel = reverse_relu_masks(Ys, Ws, bs)
    n, worst = 0, 0.0
    for i in range(Ys.shape[0]):
        h, h64 = Ys[i], Ys[i].double()
        for li, mask in enumerate(kernel):
            z = h @ Ws[li] + bs[li]
            z64 = h64 @ Ws[li].double() + bs[li].double()
            flip = (z > 0) != mask[i]
            n += int(flip.sum())
            if bool(flip.any()):
                worst = max(worst, float(z64[flip].abs().max()))
            h, h64 = torch.relu(z), torch.relu(z64)
    return n, worst


def phase_k3_edges(device, u):
    """Phase 3's K3 edge cases (K3_EDGES), K2_EDGES' operators, states and
    weights (at Burgers d 512 the port's own BurgersFuncIM operators at dt
    1e-3), a covector lam ~ N(0, 1) and the plain fp32 forward's stage
    values, at the plan's rows per block and at every forced R whose plan
    fits: lam_prev, dW and db within 1e-4 of max |ref| of the plain version
    in fp32 and in fp64 (K3's gates); lam_prev bitwise equal across R (every
    R runs the same chains); each call repeated bitwise. At d 512 the ReLU
    decisions on which the kernel and the plain version part are printed
    first (relu_flips)."""
    import torch

    from pnode_tpu_torch.ops.fused_ark_adjoint import (
        ark_adj_plan, forced_rows, fused_ark_step_adj,
        fused_ark_step_adj_plain)
    from pnode_tpu_torch.ops.fused_ark_forward import fused_ark_step_fwd_plain
    from pnode_tpu_torch.tableaus import get_ark_tableau

    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    f64 = lambda ts: [t.to(torch.float64) for t in ts]  # noqa: E731
    flat3 = lambda r: [r[0], *r[1][0], *r[1][1]]  # noqa: E731
    J_ks, inv_ks, tab_ks, _ = ks_operators(device)
    for i, (label, B, dims, act, tname) in enumerate(K3_EDGES):
        rng = np.random.default_rng(300 + i)
        d = dims[0]
        dt = float(np.float32(BDT if d == BNX else DT))
        t = get_ark_tableau(tname)
        tab = ([[float(x) for x in r] for r in t.a_im],
               [[float(x) for x in r] for r in t.a_ex],
               [float(x) for x in t.b_im], [float(x) for x in t.b_ex])
        s = len(tab[2])
        if d == NX and tname == "3":
            J, inv, tab = J_ks, inv_ks, tab_ks
        elif d == BNX:
            J, inv, tab = burgers_operators(device)[:3]
        else:
            A = rng.normal(size=(d, d))
            J64 = -2.0 * (A @ A.T) / d
            gamma = [g for g in np.diag(t.a_im) if g != 0.0][0]
            J = f32(J64)
            inv = f32(np.linalg.inv(np.eye(d) - dt * gamma * J64))
        Ws = [f32(rng.normal(0.0, a ** -0.5, size=(a, b)))
              for a, b in zip(dims, dims[1:])]
        bs = [f32(rng.normal(0.0, 0.1, size=b)) for b in dims[1:]]
        x = f32(u[rng.choice(len(u), B, replace=B > len(u))] if d == NX
                else rng.normal(size=(B, d)))
        lam = f32(rng.normal(size=(B, d)))
        Ys = fused_ark_step_fwd_plain(tab, dt, x, J, inv, Ws, bs, act)[1]
        args = (tab, dt, Ys, lam, J, inv, Ws, bs, act)
        plain = flat3(fused_ark_step_adj_plain(*args))
        ref64 = flat3(fused_ark_step_adj_plain(
            tab, dt, Ys.double(), lam.double(), J.double(), inv.double(),
            f64(Ws), f64(bs), act))
        forced = forced_rows(d, dims[1:], s)
        log(f"[kernels] K3 edge: {label} (B {B}, {dims}, {act}, ARK "
            f"{tname}, {s} stages): plan {ark_adj_plan(B, d, dims[1:], s)} "
            f"(rows, grid, B), forced R {forced}")
        if d == BNX:
            n, worst = relu_flips(Ys, Ws, bs)
            log(f"[kernels]   K3 {label}: {n} ReLU decisions part between "
                f"the kernel's and the plain version's products (largest "
                f"fp64 |z| {worst:.3e})")
        outs = {}
        for R in [0] + forced:
            got = fused_ark_step_adj(*args, rows=R)
            again = fused_ark_step_adj(*args, rows=R)
            torch.cuda.synchronize()
            check_kernel(f"fused_ark_step_adj R {R or 'plan'}", flat3(got),
                         plain, ref64, 1e-4, {})
            if not all(torch.equal(a, b)
                       for a, b in zip(flat3(got), flat3(again))):
                raise AssertionError(f"K3 {label} at R {R} is not "
                                     "deterministic")
            outs[R] = got[0]
        same = all(torch.equal(lp, outs[0]) for lp in outs.values())
        log(f"[kernels]   K3 {label}: each call repeated bitwise; lam_prev "
            f"{'bitwise equal' if same else 'DIFFERENT'} across R "
            f"{sorted(outs)}")
        if not same:
            raise AssertionError(f"K3 {label}: lam_prev differs across R")


def check_embedded(tab, berr, dt, x, J, inv, Ws, bs, args64, report):
    """K2's err output against the plain version: y1 and Ys as K2's (1e-5
    of their max; 1e-4 against float64); err within 1e-4 of max |err| of
    the plain version in fp32, and no farther from the plain version in
    float64 than max(1e-4, twice the plain fp32 version's own distance).
    err is a small difference of stage sums whose implicit kI is the
    difference quotient (Y - G) / (dt a_ii): at the main path's KS states
    and dt 0.2 the plain version in fp32 is itself ~1e-4 of max |err| from
    float64, so 1e-4 against float64 is out of reach of any fp32
    evaluation."""
    import torch

    from pnode_tpu_torch.ops.fused_ark_forward import (
        fused_ark_step_fwd_embedded, fused_ark_step_fwd_plain)

    y1, err, Ys = fused_ark_step_fwd_embedded(tab, berr, dt, x, J, inv, Ws,
                                              bs)
    torch.cuda.synchronize()
    p = fused_ark_step_fwd_plain(tab, dt, x, J, inv, Ws, bs, b_err=berr)
    d = fused_ark_step_fwd_plain(*args64, b_err=berr)
    check_kernel("fused_ark_step_fwd_embedded (y1, Ys)", [y1, Ys],
                 [p[0], p[2]], [d[0], d[2]], 1e-5, report)
    check_kernel(f"fused_ark_step_fwd_embedded (err, max |err| "
                 f"{float(p[1].abs().max()):.3e})", [err], [p[1]], [d[1]],
                 1e-4, report, tol64=max(1e-4, 2.0 * rel_err(p[1], d[1])))


def loop_case(device, u, B, hidden, biased, seed, K):
    """K4 operands: make_case's MLP stack and K distinct KS minibatches of
    one-step windows as (K, B, 64) tensors, in shuffled epochs as phase 4
    draws them, or drawn with replacement when B exceeds the data."""
    import torch

    rng = np.random.default_rng(seed)
    Ws, bs = make_stack(device, rng, hidden, biased)
    if B < len(u):
        pairs = ks_batches(u, K, B, seed)
        y, tgt = (np.stack([p[i] for p in pairs]) for i in (0, 1))
    else:
        idx = rng.integers(0, len(u) - 1, size=(K, B))
        y, tgt = u[idx], u[idx + 1]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    return Ws, bs, f32(y), f32(tgt)


# K4's grid form off Burgers, as K3_EDGES holds K3's: d 200 at a B no tile
# height divides, rows of 197 and 201 floats (the 4-byte loads, dW's ones
# row) and a one-layer stack, whose explicit stage runs its layer a phase
# after its stiff product
LOOP_GRID_CASES = (
    ("grid form d 200", 37, [200, 200, 200]),
    ("grid form ragged d 197", 37, [197, 201, 197]),
    ("grid form one layer d 300", 37, [300, 300]))


def grid_loop_runner(device, B, dims, tab, dt, seed, K):
    """loop_runner on K4 operands at widths ``dims`` (phase_k3_edges'
    kind): J = -2 A A^T / d with A ~ N(0, 1), inv its ARK stage inverse at
    dt, the stack N(0, 1 / fan-in) with biases N(0, 0.1), K minibatches y ~
    N(0, 1) with targets y + 0.05 N(0, 1)."""
    import torch

    rng = np.random.default_rng(seed)
    d = dims[0]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    A = rng.normal(size=(d, d))
    J64 = -2.0 * (A @ A.T) / d
    gamma = [g for g in np.diag(tab[0]) if g != 0.0][0]
    inv = np.linalg.inv(np.eye(d) - dt * gamma * J64)
    Ws = [f32(rng.normal(0.0, a ** -0.5, size=(a, b)))
          for a, b in zip(dims, dims[1:])]
    bs = [f32(rng.normal(0.0, 0.1, size=b)) for b in dims[1:]]
    y = rng.normal(size=(K, B, d))
    tgt = y + 0.05 * rng.normal(size=y.shape)
    return loop_runner(tab, dt, f32(J64), f32(inv), Ws, bs, f32(y), f32(tgt))


def loop_runner(tab, dt, J, inv, Ws, bs, y, tgt, sign=-1.0):
    """run(fn, K, eps, dtype, k0, state, **kw): fn (the kernel's wrapper or
    its plain version) over minibatches k0 .. k0 + K - 1, from ``state``
    (weights, biases, m, v after k0 updates) or from the given weights and
    zero Adam moments; f_EX = sign * MLP (KS -1, Burgers +1)."""
    import torch

    def run(fn, K, eps, dtype=torch.float32, k0=0, state=None, **kw):
        cast = lambda ts: [t.to(dtype) for t in ts]  # noqa: E731
        if state is None:
            z = ([torch.zeros_like(w, dtype=dtype) for w in Ws],
                 [torch.zeros_like(b, dtype=dtype) for b in bs])
            state = (cast(Ws), cast(bs), z, z)
        return fn(tab, dt, y[k0:k0 + K].to(dtype), tgt[k0:k0 + K].to(dtype),
                  J.to(dtype), inv.to(dtype), *state, k0, sign=sign, lr=LR,
                  eps=eps, **kw)

    run.operands = (tab, dt, J, inv, Ws, bs, y, tgt, sign)
    return run


def loop_masked_step(run, k, eps, state):
    """Iteration k of ``run``'s loop from ``state`` (weights, biases, m, v
    after k updates; None: the start) by the plain version in fp64 with
    the kernel's own ReLU decisions: K2, whose forward_step chains K4's
    forward shares, gives the fp32 stage values, and reverse_relu_masks
    the reverse's decisions on them in the kernel's summation order; the
    fp64 run computes everything else itself. Returns (ReLU decisions
    that part from the plain fp32 version's, the largest fp64 |z| among
    them, the weights and biases after the step)."""
    import torch

    from pnode_tpu_torch.ops.fused_ark_adjoint import (
        fused_ark_step_adj_plain, reverse_relu_masks)
    from pnode_tpu_torch.ops.fused_ark_forward import (
        fused_ark_step_fwd, fused_ark_step_fwd_plain)
    from pnode_tpu_torch.ops.fused_train_loop import adam_step_plain

    tab, dt, J, inv, Ws, bs, y, tgt, sign = run.operands
    if state is None:
        zeros = lambda ts: [torch.zeros_like(t) for t in ts]  # noqa: E731
        state = (Ws, bs, (zeros(Ws), zeros(bs)), (zeros(Ws), zeros(bs)))
    W, b, m, v = state
    Ys = fused_ark_step_fwd(tab, dt, y[k], J, inv, W, b, "relu", sign)[1]
    flips, worst = relu_flips(Ys, W, b)
    per = reverse_relu_masks(Ys, W, b)
    masks = [[mm[i] for mm in per] for i in range(len(tab[2]))]
    d64 = lambda ts: [t.double() for t in ts]  # noqa: E731
    J64, inv64 = J.double(), inv.double()
    params = [d64(W), d64(b)]
    y1, Ys64 = fused_ark_step_fwd_plain(tab, dt, y[k].double(), J64, inv64,
                                        *params, "relu", sign)
    lam = (2.0 / y1.numel()) * (y1 - tgt[k].double())
    _, grads = fused_ark_step_adj_plain(tab, dt, Ys64, lam, J64, inv64,
                                        *params, "relu", sign, masks=masks)
    adam_step_plain(params, [d64(m[0]), d64(m[1])], [d64(v[0]), d64(v[1])],
                    [list(grads[0]), list(grads[1])], k + 1, LR, 0.9, 0.999,
                    eps)
    return flips, worst, params[0] + params[1]


def norm_rel(got, ref):
    """max over tensor pairs of ||got - ref|| / ||ref|| (norm-wise)."""
    import torch

    return max(float((a.detach().double() - b.detach().double()).norm()
                     / b.detach().double().norm().clamp_min(1e-300))
               for a, b in zip(got, ref))


def check_loop(label, run, K, chunk, report, tol=5e-4, rows=0,
               stepwise=False):
    """K4 against fused_train_loop_plain on the same operands.

    - The first iteration's gradient, read as m1 / (1 - b1) after one
      iteration from zero moments (the exact check of
      tests/test_fused_train_loop.py:332-349): within 1e-4 norm-wise per
      tensor of the plain version in fp32 and in fp64.
    - K iterations at Adam eps 1e-8 and 1e-6: per-iteration losses within
      1e-4 relative; the final parameters within ``tol`` in max abs at eps
      1e-8 and norm-wise relative at eps 1e-6 (phase 4(a)'s form: below
      eps, Adam passes a gradient's rounding on amplified by up to lr/eps).
    - ``stepwise`` (Burgers-512): those parameter gates hold per iteration
      on the kernel's own trajectory, as check_adaptive's: at each of the
      K iterations kernel and plain version take one Adam step from the
      kernel's parameters, moments and count, and the kernel's parameters
      lie within ``tol`` of the plain fp32 version's or, where a ReLU unit
      within fp32 rounding of 0 parts the two (~1e-3 on a bias norm-wise),
      of the plain version in fp64 with the kernel's decisions
      (loop_masked_step), the nearer, both printed. The free-running parameters
      are printed beside the plain version's own distance from its fp64
      run and not gated: there each Adam step is ~lr against N(0, 0.1)
      weights, and an update whose gradient is near 0 moves by up to
      lr/eps times that gradient's change, so fp32 rounding alone parts
      two free runs by ~1e-2 in 8 iterations (the plain fp32 version from
      its fp64 run at eps 1e-8 and 1e-6 on an H100, PERF.md).
    ``rows``: the kernel's rows per block (0: its plan's).
    """
    import torch

    from pnode_tpu_torch.ops.fused_train_loop import (
        fused_train_loop, fused_train_loop_plain)

    grad = lambda out: [m / 0.1 for m in out[2][0] + out[2][1]]  # noqa: E731
    g_k = grad(run(fused_train_loop, 1, 1e-8, rows=rows))
    torch.cuda.synchronize()
    g_p = grad(run(fused_train_loop_plain, 1, 1e-8))
    g_d = grad(run(fused_train_loop_plain, 1, 1e-8, torch.float64))
    e32, e64, e_plain = norm_rel(g_k, g_p), norm_rel(g_k, g_d), \
        norm_rel(g_p, g_d)
    ea = max(abs_err(a, b) for a, b in zip(g_k, g_p))
    ok = e32 <= 1e-4 and e64 <= 1e-4
    log(f"[kernels]   fused_train_loop {label}: first-iteration gradient "
        f"(m1 / (1 - b1)) rel err vs plain fp32 {e32:.3e}, vs plain fp64 "
        f"{e64:.3e} (norm-wise, tol 1e-4; plain fp32 vs fp64 "
        f"{e_plain:.3e})")
    for eps in (1e-8, 1e-6):
        kk = run(fused_train_loop, K, eps, chunk=chunk, rows=rows)
        torch.cuda.synchronize()
        pp = run(fused_train_loop_plain, K, eps)
        lk, lp = kk[4].double().cpu(), pp[4].double().cpu()
        lrel = float(((lk - lp).abs() / lp.abs()).max())
        pk, pq = kk[0] + kk[1], pp[0] + pp[1]
        pabs = max(abs_err(a, b) for a, b in zip(pk, pq))
        prel = norm_rel(pk, pq)
        ea = max(ea, float((lk - lp).abs().max()))
        ok = ok and lrel <= 1e-4
        line = (f"[kernels]   fused_train_loop {label}: K {K}, chunk {chunk}, "
                f"Adam eps {eps:.0e}: losses max rel err {lrel:.3e} (tol "
                f"1e-4); params max abs {pabs:.3e}, rel (norm-wise) "
                f"{prel:.3e}")
        if stepwise:
            dd = run(fused_train_loop_plain, K, eps, torch.float64)
            pd = dd[0] + dd[1]
            line += (f"; not gated: kernel vs plain fp64 max abs "
                     f"{max(abs_err(a, b) for a, b in zip(pk, pd)):.3e}, rel "
                     f"{norm_rel(pk, pd):.3e}; plain fp32 vs fp64 max abs "
                     f"{max(abs_err(a, b) for a, b in zip(pq, pd)):.3e}, rel "
                     f"{norm_rel(pq, pd):.3e}")
        else:
            ea = max(ea, pabs)
            ok = ok and (pabs <= tol if eps == 1e-8 else prel <= tol)
            line += (f"; gated {'max abs' if eps == 1e-8 else 'rel'} at "
                     f"{tol:.0e}")
        log(line)
    for eps in (1e-8, 1e-6) if stepwise else ():
        state, lmax, gated = None, 0.0, 0.0
        for k in range(K):
            kk = run(fused_train_loop, 1, eps, k0=k, state=state, rows=rows)
            torch.cuda.synchronize()
            pp = run(fused_train_loop_plain, 1, eps, k0=k, state=state)
            pk, pq = kk[0] + kk[1], pp[0] + pp[1]
            gap = (max(abs_err(a, b) for a, b in zip(pk, pq)) if eps == 1e-8
                   else norm_rel(pk, pq))
            lmax = max(lmax, rel_max(kk[4], pp[4]))
            ea = max(ea, max(abs_err(a, b) for a, b in zip(pk, pq)))
            if gap > tol:
                flips, z, pm = loop_masked_step(run, k, eps, state)
                gm = (max(abs_err(a, b) for a, b in zip(pk, pm))
                      if eps == 1e-8 else norm_rel(pk, pm))
                log(f"[kernels]     step {k}: params vs plain fp32 {gap:.3e}"
                    f", vs plain fp64 with the kernel's ReLU decisions "
                    f"{gm:.3e} ({flips} decisions part from the plain fp32 "
                    f"version's, largest fp64 |z| {z:.3e})")
                gap = min(gap, gm)
            gated = max(gated, gap)
            state = kk[:4]
        good = lmax <= 1e-4 and gated <= tol
        ok = ok and good
        log(f"[kernels]   fused_train_loop {label}: {K} iterations one at a "
            f"time on the kernel's trajectory, Adam eps {eps:.0e}: loss max "
            f"rel err {lmax:.3e} (tol 1e-4), params after each step "
            f"{'max abs' if eps == 1e-8 else 'rel (norm-wise)'} "
            f"{gated:.3e} (tol {tol:.0e}) {'ok' if good else 'FAIL'}")
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), ea)
    if not ok:
        raise AssertionError(f"fused_train_loop ({label}) disagrees with its "
                             "plain version")


def card_sms():
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def loop_rows(plan, B, hidden, *args):
    """The rows per block in (1, 2, 4, 8) that a loop kernel's plan takes
    at B, 64 -> hidden x4 -> 64 (``args``: the plan's after the layers),
    on this card."""
    layers = [hidden] * 4 + [NX]
    return [r for r in (1, 2, 4, 8)
            if plan(B, NX, layers, *args, sms=card_sms(), rows=r) is not None]


def strided_batch():
    """A batch with more row tiles of 8 rows than the card has SMs: the
    loop kernels' grid is at most one block per SM, so at every R some
    block strides over a second row tile."""
    return 8 * card_sms() + 5


def loop_device_ms(fn, name, K):
    """The profiler's device time per iteration of loop kernel ``name``
    over calls of ``fn`` (K iterations each)."""
    us, traced = device_us_per_call(fn, [name], n=5)
    return us / 1e3 / K, traced


def loop_grid_cases(device, tab, dt, K, tol, report):
    """K4's grid form at LOOP_GRID_CASES against the plain loop, per
    iteration on the kernel's trajectory (a ReLU unit within rounding of 0
    parts fp32 runs, as at Burgers); parameters, moments and losses bitwise
    across two calls and across the plan's grid and half of it."""
    import torch

    from pnode_tpu_torch.ops.fused_train_loop import (
        fused_train_loop, train_loop_plan)

    s = len(tab[2])
    for i, (label, B, dims) in enumerate(LOOP_GRID_CASES):
        case = grid_loop_runner(device, B, dims, tab, dt, 20 + i, K)
        plan = train_loop_plan(B, dims[0], dims[1:], s, sms=card_sms())
        log(f"[kernels]   fused_train_loop {label} (B {B}, {dims}): plan "
            f"(rows, grid, smem) {plan}")
        if plan[0] != 0:
            raise AssertionError(f"K4's plan at {label} is not the grid form")
        check_loop(label, case, K, None, report, tol, stepwise=True)
        outs = [case(fn, K, 1e-8) for fn in (
            fused_train_loop, fused_train_loop, loop_at_grid(plan[1] // 2))]
        torch.cuda.synchronize()
        flat = [o[0] + o[1] + list(o[2][0]) + list(o[2][1]) + list(o[3][0])
                + list(o[3][1]) + [o[4]] for o in outs]
        bits = [all(torch.equal(a, b) for a, b in zip(flat[0], f))
                for f in flat[1:]]
        log(f"[kernels]   fused_train_loop {label}: parameters, moments and "
            f"losses bitwise across two calls {bits[0]}, across grids "
            f"{plan[1]} and {plan[1] // 2} {bits[1]}")
        if not all(bits):
            raise AssertionError(f"fused_train_loop {label}: the grid form is "
                                 "not bitwise stable")


def phase_loop_kernel(device, u, J, inv, tab, dt, K=8, tol=5e-4):
    """Phase 3 for K4, against the plain loop at every rows per block its
    plan takes (1, 2, 4, 8): the main path (B 256, 64 -> 104 x4 -> 64),
    the ragged case (B 37, hidden 24, nonzero biases, chunk=8), an odd
    hidden width (B 37, hidden 13: every weight takes the 4-byte copies,
    through L2, where a stale L1 line would show) and a batch with more row
    tiles than the grid has blocks; the grid form at LOOP_GRID_CASES (per
    iteration on the kernel's trajectory, bitwise across two calls and two
    grids); K = 16 as two launches of 8 against one launch; two calls
    bitwise equal; time per iteration, kernel and plain version in turns,
    and the kernel's device time."""
    import torch

    from pnode_tpu_torch.ops.fused_train_loop import (
        fused_train_loop, fused_train_loop_plain, train_loop_plan)

    report = {}
    s = len(tab[2])
    log(f"[kernels] fused_train_loop: K {K} distinct KS minibatches, Adam "
        f"lr {LR}")
    main = loop_case(device, u, BATCH, HIDDEN, False, 1, 2 * K)
    run = loop_runner(tab, dt, J, inv, *main)
    wide = strided_batch()
    for label, B, hidden, chunk, seed in (
            (f"B{BATCH} h{HIDDEN}", BATCH, HIDDEN, None, 1),
            ("B37 h24 biased", 37, 24, 8, 2),
            ("B37 h13 biased (odd width)", 37, 13, None, 4),
            (f"B{wide} h24 biased (blocks stride)", wide, 24, None, 3)):
        case = run if B == BATCH else loop_runner(
            tab, dt, J, inv, *loop_case(device, u, B, hidden, True, seed, K))
        rows = loop_rows(train_loop_plan, B, hidden, s)
        plan = train_loop_plan(B, NX, [hidden] * 4 + [NX], s,
                               sms=card_sms())
        log(f"[kernels]   fused_train_loop {label}: plan (rows, grid, smem) "
            f"{plan}; forced rows {rows}")
        for r in rows:
            check_loop(f"{label} R {r}", case, K, chunk, report, tol, rows=r)

    loop_grid_cases(device, tab, dt, K, tol, report)

    # persistence across launches: the state one launch leaves in device
    # memory seeds the next
    one = run(fused_train_loop, 2 * K, 1e-8)
    two = run(fused_train_loop, 2 * K, 1e-8, chunk=K)
    again = run(fused_train_loop, 2 * K, 1e-8)
    torch.cuda.synchronize()
    lrel = float(((two[4] - one[4]).abs() / one[4].abs()).max())
    pabs = max(abs_err(a, b) for a, b in zip(two[0] + two[1],
                                             one[0] + one[1]))
    same = all(torch.equal(a, b) for a, b in zip(
        two[0] + two[1] + [two[4]], one[0] + one[1] + [one[4]]))
    repeat = all(torch.equal(a, b) for a, b in zip(
        again[0] + again[1] + [again[4]], one[0] + one[1] + [one[4]]))
    log(f"[kernels]   fused_train_loop K {2 * K}: chunk {K} vs one launch: "
        f"losses max rel {lrel:.3e}, params max abs {pabs:.3e} (bitwise "
        f"equal: {same}; tol 1e-4, {tol:.0e}); two calls bitwise equal: "
        f"{repeat}")
    if not (lrel <= 1e-4 and pabs <= tol):
        raise AssertionError("fused_train_loop loses its state across "
                             "launches")
    if not repeat:
        raise AssertionError("fused_train_loop: two calls differ")

    # per iteration: plain, kernel, kernel, plain
    kern = lambda: run(fused_train_loop, K, 1e-8)  # noqa: E731
    plain = lambda: run(fused_train_loop_plain, K, 1e-8)  # noqa: E731
    p1 = summary(cuda_times_ms(plain, reps=10, warmup=1, inner=1))
    k1 = summary(cuda_times_ms(kern, reps=10, warmup=2, inner=3))
    k2 = summary(cuda_times_ms(kern, reps=10, warmup=2, inner=3))
    p2 = summary(cuda_times_ms(plain, reps=10, warmup=1, inner=1))
    report["ms"] = min(k1[0], k2[0]) / K
    report["plain_ms"] = min(p1[0], p2[0]) / K
    report["device_ms"], traced = loop_device_ms(kern, "train_loop_kernel",
                                                 K)
    log(f"[kernels]   fused_train_loop per iteration: kernel median "
        f"{k1[0] / K:.4f} / {k2[0] / K:.4f} ms (p66 {k1[1] / K:.4f} / "
        f"{k2[1] / K:.4f}), plain median {p1[0] / K:.4f} / {p2[0] / K:.4f} ms "
        f"(p66 {p1[1] / K:.4f} / {p2[1] / K:.4f}); 10 samples of 3 (kernel) "
        f"or 1 (plain) back-to-back calls of K {K}; device "
        f"{report['device_ms']:.4f} ms per iteration ({traced} launches "
        f"traced)")
    return report


def adaptive_runner(stp, Ws, bs, y, tgt, dt0):
    """run(fn, K, eps, dtype, k0, state): fn (K5's wrapper or its plain
    version) over minibatches k0 .. k0 + K - 1 with the main path's
    controller (rtol = atol = 1e-4, MAX_TRIALS trials, window [0, DT]),
    from ``state`` = (weights, biases, m, v, t0, dt0), by default
    ``run.state0``: the case's weights, zero Adam moments, t0 0 and dt0;
    ``run.shape`` is (B, d, stages)."""
    import torch

    J = stp.setup.frozen_J_blocks[0]
    lam, Q = stp._spectral_stage_basis(J)
    tab = stp._tableau_static() + (stp._bIe, stp._bEe)

    def run(fn, K, eps, dtype=torch.float32, k0=0, state=None, **kw):
        cast = lambda ts: [t.to(dtype) for t in ts]  # noqa: E731
        W, b, m, v, t0, d0 = run.state0 if state is None else state
        return fn(tab, GAMMA, lam.to(dtype), Q.to(dtype), J.to(dtype), DT,
                  d0, y[k0:k0 + K].to(dtype), tgt[k0:k0 + K].to(dtype),
                  cast(W), cast(b), (cast(m[0]), cast(m[1])),
                  (cast(v[0]), cast(v[1])), t0, MAX_TRIALS, rtol=1e-4,
                  atol=1e-4, order=stp.tab.order, lr=LR, eps=eps, **kw)

    z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b) for b in bs])
    run.state0 = (Ws, bs, z, z, 0, dt0)
    run.shape = (int(y.shape[1]), int(y.shape[2]), len(tab[2]))
    return run


def stats_rows(out):
    """Per-iteration (accepted, rejected, completed) of a K5 result."""
    st = out[5]
    return [tuple(int(st[n][i]) for n in ("accepted", "rejected",
                                          "completed"))
            for i in range(len(out[4]))]


def rel_max(a, b):
    """max |a - b| / |b| elementwise (b the reference)."""
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def check_adaptive(label, run, K, report, tol=5e-4, min_rejected=0,
                   drift=False, block_rows=0):
    """K5 against fused_adaptive_train_loop_plain on the same operands.

    - On one trajectory (phase 4(a)'s per-step form): K iterations, one
      launch each, from the kernel run's parameters, Adam moments and
      warm-start dt; at each, kernel and plain version run one probe
      iteration from those parameters and zero moments, whose m1 / (1 -
      b1) is the iteration's gradient. Per iteration: accepted, rejected
      and completed equal; dt_first within 1e-5 relative; dt_last within
      5e-2 (the controller's proposal after the landing trial, a MATCHSTEP
      sliver whose error estimate is a few times 1e-3 of the tolerance and
      carries fp32 rounding of the same size, moved by the 1/(order+1)
      power: two correct fp32 evaluations put it up to 1e-2 apart on the
      card, and nothing consumes it; a wrong controller branch, the clip
      or no growth after a rejection, moves it by 10% or more); loss
      within 1e-4 relative; gradient within ``tol`` norm-wise per tensor
      of the plain version or of the plain version in fp64 with the
      kernel's own ReLU decisions (``adaptive_masked_reference``), both
      printed.
    - Free-running, K iterations in one launch at Adam eps 1e-8 and 1e-6:
      decisions equal, losses within 1e-4 relative, at least
      ``min_rejected`` rejections; at eps 1e-6 the final parameters within
      ``tol`` norm-wise (phase 4(a)'s form) of the plain version or of the
      plain version in fp64 with the kernel's own ReLU decisions
      (``adaptive_params_gap``). dt_first, dt_last and
      the final parameters at eps 1e-8 (max abs, phase 4(a)'s form there)
      are printed and not gated: with kI = Y J^T the rounding of a stage
      product reaches the gradient multiplied by |J|, and Adam below eps
      multiplies a gradient's rounding by up to lr/eps = 5e5, so two
      free-running fp32 trajectories part (after 8 iterations the plain
      version in fp32 is itself 3.2e-3, max abs, from the plain version
      in fp64 at the main path), and with them the error estimates that
      set a rejected first trial's dt. ``drift`` runs the fp64 plain
      version and prints that distance beside the kernel's.
    ``block_rows``: the kernel's rows per block (0: its plan's).
    """
    import torch

    from pnode_tpu_torch.ops.fused_adaptive_loop import (
        fused_adaptive_train_loop as kern,
        fused_adaptive_train_loop_plain as plain)

    grad = lambda out: [m / 0.1 for m in out[2][0] + out[2][1]]  # noqa: E731
    W, b, m, v, t0, dt = run.state0
    z = run.state0[2]
    same, ea = True, 0.0
    worst = {"grad": 0.0, "loss": 0.0, "dt_first": 0.0, "dt_last": 0.0,
             "fp32": 0.0, "masked": 0.0}
    rows = []
    for k in range(K):
        probe = (W, b, z, z, 0, dt)
        pk = run(kern, 1, 1e-8, k0=k, state=probe, rows=block_rows)
        torch.cuda.synchronize()
        pp = run(plain, 1, 1e-8, k0=k, state=probe)
        e32 = norm_rel(grad(pk), grad(pp))
        pm, note = adaptive_masked_reference(run, 1, 1e-8, pk, block_rows,
                                             probe, k)
        em = norm_rel(grad(pk), grad(pm)) if pm else float("inf")
        if k == 0 or e32 > tol:
            pd = run(plain, 1, 1e-8, torch.float64, k0=k, state=probe)
            log(f"[kernels]   fused_adaptive_train_loop {label}: iteration "
                f"{k}'s gradient vs plain fp32 {e32:.3e}, vs plain fp64 "
                f"{norm_rel(grad(pk), grad(pd)):.3e} (plain fp32 vs fp64 "
                f"{norm_rel(grad(pp), grad(pd)):.3e}; fp64 trials "
                f"{stats_rows(pd)}), vs plain fp64 with the kernel's ReLU "
                f"decisions {em:.3e}{note}")
        rows += stats_rows(pk)
        same = same and stats_rows(pk) == stats_rows(pp)
        for name in ("dt_first", "dt_last"):
            worst[name] = max(worst[name], rel_max(pk[5][name], pp[5][name]))
        worst["loss"] = max(worst["loss"], rel_max(pk[4], pp[4]))
        worst["fp32"] = max(worst["fp32"], e32)
        worst["masked"] = max(worst["masked"], em)
        worst["grad"] = max(worst["grad"], min(e32, em))
        ea = max([ea, abs_err(pk[4], pp[4])]
                 + [abs_err(x, y) for x, y in zip(grad(pk), grad(pp))])
        adv = run(kern, 1, 1e-8, k0=k, state=(W, b, m, v, t0, dt),
                  rows=block_rows)
        W, b, m, v = adv[0], adv[1], adv[2], adv[3]
        t0, dt = t0 + 1, float(adv[5]["dt_first"][0])
    ok = (same and worst["dt_first"] <= 1e-5 and worst["dt_last"] <= 5e-2
          and worst["loss"] <= 1e-4 and worst["grad"] <= tol)
    log(f"[kernels]   fused_adaptive_train_loop {label}: {K} iterations on "
        f"one trajectory, (accepted, rejected, completed) {rows} (plain "
        f"{'equal' if same else 'DIFFERENT'}); max rel err dt_first "
        f"{worst['dt_first']:.3e} (tol 1e-5), dt_last {worst['dt_last']:.3e} "
        f"(tol 5e-2), loss {worst['loss']:.3e} (tol 1e-4), gradient vs "
        f"plain fp32 {worst['fp32']:.3e}, vs plain fp64 with the kernel's "
        f"ReLU decisions {worst['masked']:.3e}, the nearer "
        f"{worst['grad']:.3e} (norm-wise, tol {tol:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    for eps in (1e-8, 1e-6):
        kk = run(kern, K, eps, rows=block_rows)
        torch.cuda.synchronize()
        pp = run(plain, K, eps)
        rows_k, rows_p = stats_rows(kk), stats_rows(pp)
        dtf = rel_max(kk[5]["dt_first"], pp[5]["dt_first"])
        dtl = rel_max(kk[5]["dt_last"], pp[5]["dt_last"])
        lrel = rel_max(kk[4], pp[4])
        pk, pq = kk[0] + kk[1], pp[0] + pp[1]
        n_rej = sum(r[1] for r in rows_k)
        ea = max(ea, abs_err(kk[4], pp[4]))
        prel, gated = norm_rel(pk, pq), ""
        if eps == 1e-6:
            prel, gated = adaptive_params_gap(run, K, eps, kk, pp,
                                              block_rows, tol)
        good = (rows_k == rows_p and lrel <= 1e-4 and n_rej >= min_rejected
                and (eps == 1e-8 or prel <= tol))
        ok = ok and good
        log(f"[kernels]   fused_adaptive_train_loop {label}: K {K} in one "
            f"launch, Adam eps {eps:.0e}: (accepted, rejected, completed) "
            f"{rows_k} (plain {'equal' if rows_k == rows_p else rows_p}); "
            f"losses max rel err {lrel:.3e} (tol 1e-4)" + gated
            + (f"; rejections {n_rej} (at least {min_rejected})"
               if min_rejected else "") + f" {'ok' if good else 'FAIL'}")
        line = (f"[kernels]     not gated: max rel err dt_first {dtf:.3e}, "
                f"dt_last {dtl:.3e}; final parameters kernel vs plain fp32 "
                f"max abs {max(abs_err(x, y) for x, y in zip(pk, pq)):.3e}, "
                f"rel (norm-wise) {norm_rel(pk, pq):.3e}")
        if drift and eps == 1e-8:
            dd = run(plain, K, eps, torch.float64)
            pd = dd[0] + dd[1]
            line += (f"; plain fp32 vs plain fp64 max abs "
                     f"{max(abs_err(x, y) for x, y in zip(pq, pd)):.3e}, rel "
                     f"{norm_rel(pq, pd):.3e}; kernel vs plain fp64 max abs "
                     f"{max(abs_err(x, y) for x, y in zip(pk, pd)):.3e} (fp64 "
                     f"decisions {'equal' if stats_rows(dd) == rows_k else stats_rows(dd)})")
        log(line)
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), ea)
    if not ok:
        raise AssertionError(f"fused_adaptive_train_loop ({label}) disagrees "
                             "with its plain version")


def adaptive_masked_reference(run, K, eps, out, block_rows, state=None,
                              k0=0):
    """The plain version in fp64 with K5's own ReLU decisions: the
    reference, beside the plain fp32 version, for a K5 result ``out`` (K
    iterations from ``state``, by default ``run.state0``, minibatches k0
    ..). A hidden unit whose preactivation is within fp32
    rounding of 0 goes either way in two correct fp32 evaluations, and the
    flip moves a layer's gradient by ~1e-3 norm-wise, so neither plain run
    can tell a right kernel from a wrong one there. The kernel's
    decisions: the same K iterations as K chained one-iteration launches
    (equal to ``out`` bitwise, or no reference), each with a device
    workspace read after it, which holds that iteration's trial stage
    values; ``reverse_relu_masks`` recomputes from them, with the launch's
    weights, the preactivations in the kernel's summation order. The fp64
    run computes everything else itself, so a kernel whose stage values,
    weights or sums were wrong still misses it. Returns (the fp64 run, or
    None where the chain is not bitwise or the fp64 run's decisions
    differ, and a note for the log)."""
    import torch

    from pnode_tpu_torch.ops.fused_adaptive_loop import (
        adaptive_loop_plan, fused_adaptive_train_loop as kern,
        fused_adaptive_train_loop_plain as plain)
    from pnode_tpu_torch.ops.fused_ark_adjoint import reverse_relu_masks

    state = run.state0 if state is None else state
    W, b, m, v, t0, dt = state
    B, d, s = run.shape
    floats = adaptive_loop_plan(B, d, [int(w.shape[1]) for w in W], s,
                                MAX_TRIALS, sms=card_sms(),
                                rows=block_rows)[3]
    masks = {}
    for k in range(K):
        ws = torch.empty(floats, dtype=torch.float32, device=W[0].device)
        one = run(kern, 1, eps, k0=k0 + k, state=(W, b, m, v, t0, dt),
                  rows=block_rows, workspace=ws)
        n = int(one[5]["accepted"][0]) + int(one[5]["rejected"][0])
        per = reverse_relu_masks(ws[:n * s * B * d].view(n, s, B, d), W, b)
        for t in range(n):
            masks[k, t] = [[mm[t, i] for mm in per] for i in range(s)]
        W, b, m, v = one[0], one[1], one[2], one[3]
        t0, dt = t0 + 1, float(one[5]["dt_first"][0])
    chained = all(torch.equal(x, y) for x, y in zip(W + b, out[0] + out[1]))
    ref = run(plain, K, eps, torch.float64, k0=k0, state=state,
              relu_masks=lambda k, n: masks.get((k, n)))
    same = stats_rows(ref) == stats_rows(out)
    note = (f" ({K} chained launches bitwise equal: {chained}; its "
            f"decisions {'equal' if same else stats_rows(ref)})")
    return (ref if chained and same else None), note


def adaptive_params_gap(run, K, eps, out, pp, block_rows, tol):
    """The gate on a free-running K5 result ``out`` (K iterations in one
    launch from ``run.state0``): its final parameters' norm-wise distance
    from the plain version's ``pp`` or from the plain version in fp64 with
    the kernel's own ReLU decisions (``adaptive_masked_reference``),
    whichever is nearer; the plain fp64 run without them is printed
    beside them. Returns (the distance, a part of a log line)."""
    import torch

    from pnode_tpu_torch.ops.fused_adaptive_loop import (
        fused_adaptive_train_loop_plain as plain)

    pk = out[0] + out[1]
    e32 = norm_rel(pk, pp[0] + pp[1])
    dd = run(plain, K, eps, torch.float64)
    pd = dd[0] + dd[1]
    ref, note = adaptive_masked_reference(run, K, eps, out, block_rows)
    em = norm_rel(pk, ref[0] + ref[1]) if ref else float("inf")
    return min(e32, em), (
        f"; final parameters rel (norm-wise) {e32:.3e}, vs plain fp64 "
        f"{norm_rel(pk, pd):.3e} (plain fp32 vs fp64 "
        f"{norm_rel(pp[0] + pp[1], pd):.3e}), vs plain fp64 with the "
        f"kernel's ReLU decisions {em:.3e}{note}, the nearer "
        f"{min(e32, em):.3e} (tol {tol:.0e})")


def phase_adaptive_kernel(device, u, stp, K=8):
    """Phase 3 for K5, against its plain version on K KS minibatches at
    every rows per block its plan takes (1, 2, 4, 8): the main path (B 256,
    hidden 104, dt0 warm from a probe call), the ragged case (B 37, hidden
    24, nonzero biases), an odd hidden width (B 37, hidden 13: the 4-byte
    weight copies), a cold dt0 = DT that must reject, and a batch whose row
    tiles outnumber the grid's blocks; two calls bitwise equal, and two
    launches of K/2 carrying the state bitwise equal to one of K; then
    time per iteration, kernel and plain version in turns, and the
    kernel's device time."""
    import torch

    from pnode_tpu_torch.ops.fused_adaptive_loop import (
        adaptive_loop_plan, fused_adaptive_train_loop,
        fused_adaptive_train_loop_plain)

    report = {}
    s = len(stp._tableau_static()[2])
    log(f"[kernels] fused_adaptive_train_loop: K {K} distinct KS "
        f"minibatches, rtol = atol = 1e-4, {MAX_TRIALS} trials, Adam lr {LR}")
    main = loop_case(device, u, BATCH, HIDDEN, False, 1, K)
    probe = adaptive_runner(stp, *main, DT)(fused_adaptive_train_loop, 1,
                                            1e-8)
    dt_warm = float(probe[5]["dt_first"][0])
    log(f"[kernels]   probe call from dt0 {DT}: dt_first {dt_warm:.6g}")
    run = adaptive_runner(stp, *main, dt_warm)
    wide = strided_batch()
    for label, B, hidden, runner, extra in (
            (f"B{BATCH} h{HIDDEN} warm", BATCH, HIDDEN, run,
             dict(drift=True)),
            ("B37 h24 biased", 37, 24, adaptive_runner(
                stp, *loop_case(device, u, 37, 24, True, 2, K), dt_warm), {}),
            ("B37 h13 biased (odd width)", 37, 13, adaptive_runner(
                stp, *loop_case(device, u, 37, 13, True, 4, K), dt_warm), {}),
            (f"B{BATCH} h{HIDDEN} cold dt0 {DT}", BATCH, HIDDEN,
             adaptive_runner(stp, *main, DT), dict(min_rejected=1)),
            (f"B{wide} h24 biased (blocks stride)", wide, 24, adaptive_runner(
                stp, *loop_case(device, u, wide, 24, True, 3, K), dt_warm),
             {})):
        rows = loop_rows(adaptive_loop_plan, B, hidden, s, MAX_TRIALS)
        plan = adaptive_loop_plan(B, NX, [hidden] * 4 + [NX], s, MAX_TRIALS,
                                  sms=card_sms())
        log(f"[kernels]   fused_adaptive_train_loop {label}: plan (rows, "
            f"grid, smem, workspace floats) {plan}; forced rows {rows}")
        for r in rows:
            # the fp64 drift once per case, at its first R
            kw = extra if r == rows[0] else {
                k: v for k, v in extra.items() if k != "drift"}
            check_adaptive(f"{label} R {r}", runner, K, report,
                           block_rows=r, **kw)

    kern = lambda: run(fused_adaptive_train_loop, K, 1e-8)  # noqa: E731
    plain = lambda: run(fused_adaptive_train_loop_plain, K, 1e-8)  # noqa
    first, second = kern(), kern()
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(
        first[0] + first[1] + [first[4]] + list(first[5].values()),
        second[0] + second[1] + [second[4]] + list(second[5].values())))
    # persistence across launches: two launches of K/2, the second from the
    # first's parameters, moments, t0 and dt_first warm start, equal one
    # launch of K
    half = run(fused_adaptive_train_loop, K // 2, 1e-8)
    rest = run(fused_adaptive_train_loop, K - K // 2, 1e-8, k0=K // 2,
               state=(half[0], half[1], half[2], half[3], K // 2,
                      float(half[5]["dt_first"][-1])))
    torch.cuda.synchronize()
    chained = all(torch.equal(a, b) for a, b in zip(
        rest[0] + rest[1] + [torch.cat([half[4], rest[4]])],
        first[0] + first[1] + [first[4]]))
    log(f"[kernels]   fused_adaptive_train_loop: two calls bitwise equal: "
        f"{repeat}; {K // 2} + {K - K // 2} iterations in two launches "
        f"bitwise equal to {K} in one: {chained}")
    if not repeat:
        raise AssertionError("fused_adaptive_train_loop: two calls differ")
    if not chained:
        raise AssertionError("fused_adaptive_train_loop loses its state "
                             "across launches")
    p1 = summary(cuda_times_ms(plain, reps=5, warmup=1, inner=1))
    k1 = summary(cuda_times_ms(kern, reps=10, warmup=2, inner=3))
    k2 = summary(cuda_times_ms(kern, reps=10, warmup=2, inner=3))
    p2 = summary(cuda_times_ms(plain, reps=5, warmup=1, inner=1))
    report["ms"] = min(k1[0], k2[0]) / K
    report["plain_ms"] = min(p1[0], p2[0]) / K
    report["device_ms"], traced = loop_device_ms(
        kern, "adaptive_loop_kernel", K)
    rows = stats_rows(run(fused_adaptive_train_loop, K, 1e-8))
    # the timed runs' work per iteration, for the roofline bound
    report["accepted"] = float(np.mean([r[0] for r in rows]))
    report["rejected"] = float(np.mean([r[1] for r in rows]))
    log(f"[kernels]   fused_adaptive_train_loop per iteration: kernel median "
        f"{k1[0] / K:.4f} / {k2[0] / K:.4f} ms (p66 {k1[1] / K:.4f} / "
        f"{k2[1] / K:.4f}), plain median {p1[0] / K:.4f} / {p2[0] / K:.4f} ms "
        f"(p66 {p1[1] / K:.4f} / {p2[1] / K:.4f}); 10 samples of 3 (kernel) "
        f"or 5 samples of 1 (plain) back-to-back calls of K {K}; device "
        f"{report['device_ms']:.4f} ms per iteration ({traced} launches "
        f"traced); trials per iteration {rows}")
    return report


# -- phase 4 ------------------------------------------------------------------

def ks_batches(u, n_iters, batch, seed):
    """One-step windows (y0 = u[i], target u[i+1]) in shuffled minibatches,
    epoch after epoch, as (y0, target) numpy pairs."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n_iters:
        starts = np.arange(len(u) - 1)
        rng.shuffle(starts)
        for b in range(len(starts) // batch):
            s = starts[b * batch:(b + 1) * batch]
            out.append((u[s], u[s + 1]))
    return out[:n_iters]


def build_trainer(device, state, fused, flags=(), eps=1e-8, batch=BATCH):
    """(ode, ex module, optimizer) of the KS IMEX model from ``state`` for
    ``batch`` rows; Adam at lr 5e-3 and epsilon ``eps`` (torch's and
    optax's default)."""
    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.models import KSFuncEX, KSFuncIM

    pt.clear_options()
    pt.init(["chip_smoke", "-snes_type", "ksponly"] + list(flags))
    im = KSFuncIM(nx=NX, device=device)
    ex = KSFuncEX(nx=NX, hidden=HIDDEN, use_fused=fused, device=device)
    ex.load_state_dict(state)
    ode = pt.ODESolver()
    ode.setupTS(torch.zeros(batch, NX, device=device), pt.TorchFunc(im),
                step_size=DT, method="imex", imex_form=True,
                func2=pt.TorchFunc(ex), linear_solver="hpddm",
                fixed_jacobian=True, batch_size=batch)
    return ode, ex, torch.optim.Adam(ex.parameters(), lr=LR, eps=eps)


def train(ode, ex, opt, batches, device, dt=DT):
    """One Adam iteration per batch; returns the losses as a tensor."""
    import torch

    t_out = np.array([0.0, dt])
    losses = []
    for y0, tgt in batches:
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=device)
        tgt = torch.as_tensor(tgt, dtype=torch.float32, device=device)
        pred = ode.odeint_adjoint(y0, t_out)
        loss = torch.mean((pred[-1] - tgt) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses)


def loss_and_grads(ode, ex, y0, tgt, device, dt=DT):
    """(loss, gradient tensors) of one step's MSE; leaves them in .grad."""
    import torch

    y0 = torch.as_tensor(y0, dtype=torch.float32, device=device)
    tgt = torch.as_tensor(tgt, dtype=torch.float32, device=device)
    for p in ex.parameters():
        p.grad = None
    pred = ode.odeint_adjoint(y0, np.array([0.0, dt]))
    loss = torch.mean((pred[-1] - tgt) ** 2)
    loss.backward()
    return float(loss.detach()), [p.grad.detach().clone()
                                  for p in ex.parameters()]


def device_kernels(events):
    """(kernel events, busy us) of a trace's raw events: kernels are device
    events that are neither user annotations (a span's device-side copy)
    nor the CPU ops that launched them, so no device interval is counted
    twice; busy is the union of their intervals."""
    from torch.autograd import DeviceType

    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in cpu_names]
    busy_us, end_us = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        lo = max(e.time_range.start, end_us)
        busy_us += max(0.0, e.time_range.end - lo)
        end_us = max(end_us, e.time_range.end)
    return kernels, busy_us


def profile_steps(label, ode, ex, opt, batches, device, dt=DT, focus=None):
    """A traced run of kernel-path training steps: host time per layer
    (spans around the solve, the loss, the adjoint and Adam), device time
    per kernel, and the device's busy share of the traced wall time. With
    ``focus`` = (substring, label), also the device time of the kernels
    whose name holds the substring, and its share of the step. Returns the
    busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    t_out = np.array([0.0, dt])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for y0, tgt in batches:
            y0 = torch.as_tensor(y0, dtype=torch.float32, device=device)
            tgt = torch.as_tensor(tgt, dtype=torch.float32, device=device)
            with record_function("span:solve"):
                pred = ode.odeint_adjoint(y0, t_out)
            with record_function("span:loss"):
                loss = torch.mean((pred[-1] - tgt) ** 2)
            opt.zero_grad(set_to_none=True)
            with record_function("span:adjoint"):
                loss.backward()
            with record_function("span:adam"):
                opt.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels, busy_us = device_kernels(events)
    n = len(batches)
    spans, per_kernel = {}, {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("span:"):
            spans[e.name] = spans.get(e.name, 0.0) + e.time_range.elapsed_us()
    for e in kernels:
        us, count = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    log(f"[profile] {label}: {n} traced steps, {1e3 * wall / n:.3f} ms/step; "
        f"device busy {busy_us * 1e-6 / wall:.3f} of the wall time")
    log("[profile] host us/step: " + ", ".join(
        f"{k[5:]} {v / n:.1f}" for k, v in sorted(spans.items())))
    if focus is not None:
        mine = [v for k, v in per_kernel.items() if focus[0] in k]
        us, count = sum(v[0] for v in mine), sum(v[1] for v in mine)
        log(f"[profile] {focus[1]} ({focus[0]}*): {us / n:.1f} us/step over "
            f"{count // n} launches, {us / max(busy_us, 1e-9):.3f} of the "
            f"device's busy time, {us * 1e-6 / wall:.3f} of the wall time")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in top[:8]:
        log(f"[profile]   {us / n:9.1f} us/step x{count // n:<3d} {name[:90]}")
    if not kernels:
        log("[profile] the profiler recorded no device time")
    return busy_us * 1e-6 / wall


def to_linear_state(fused_state):
    """nn.Linear state_dict of the same weights (weight is (out, in))."""
    out = {}
    i = 0
    while f"net.kernel_{i}" in fused_state:
        out[f"net.layers.{i}.weight"] = fused_state[f"net.kernel_{i}"].t().contiguous()
        out[f"net.layers.{i}.bias"] = fused_state[f"net.bias_{i}"].clone()
        i += 1
    return out


def ks_data(n_samples=600):
    from pnode_tpu_torch.data import generate_ks_data

    u, _ = generate_ks_data(nx=NX, L=22.0, n_samples=n_samples, dt_data=DT,
                            cache_dir=os.path.join(ROOT, "build", "data"))
    return u


def phase_paths_agree(device, state0, batches, tol=5e-4):
    """Phase 4(a): the kernel path against the generic stage loop through
    K1 (-pnode_fused_ark_adjoint off), from the same weights and batches.

    - At each Adam step, both paths evaluate the loss and the gradients from
      the kernel path's parameters: within ``tol`` relative (gradients
      norm-wise per tensor).
    - Run free, the two loss trajectories agree within ``tol`` relative.
    - Run free at Adam's default eps, the final parameters agree within
      ``tol`` in max abs: the form of the reference's own chip gate
      (tools/hardware_smoke.py gate 7). The KS init's weight gradients are
      ~1e-9, below eps, where Adam's step lr*g/(|g| + eps) passes a
      gradient's rounding on to the parameter amplified by lr/eps, so a
      relative gate on parameters does not hold between two correct fp32
      evaluations there.
    - Run free at Adam eps 1e-6, above those gradients, the final
      parameters agree within ``tol`` relative (norm-wise per tensor).

    Returns the kernel path's free-running runs, {eps: (losses, params)}.
    """
    import torch

    import pnode_tpu_torch as pt

    off = ["-pnode_fused_ark_adjoint", "off"]
    ode, ex, opt = build_trainer(device, state0, fused=True)
    step_l = step_g = 0.0
    losses = []
    for y0, tgt in batches:
        pt.set_option("pnode_fused_ark_adjoint", "off")
        l_g, g_g = loss_and_grads(ode, ex, y0, tgt, device)
        pt.set_option("pnode_fused_ark_adjoint", "auto")
        l_k, g_k = loss_and_grads(ode, ex, y0, tgt, device)
        step_l = max(step_l, abs(l_k - l_g) / abs(l_g))
        step_g = max(step_g, max(float((a - b).norm() / b.norm())
                                 for a, b in zip(g_k, g_g)))
        opt.step()
        losses.append(l_k)
    log(f"[slice] (a) {len(batches)} Adam steps, kernel path vs generic "
        f"loop through K1 from the same parameters: max rel err loss "
        f"{step_l:.3e}, gradients {step_g:.3e} (norm-wise; tol {tol:.0e})")
    # the loop above is the kernel path's free-running trajectory
    kernel_runs = {1e-8: (torch.tensor(losses), list(ex.parameters()))}
    ode, ex, opt = build_trainer(device, state0, True, eps=1e-6)
    kernel_runs[1e-6] = (train(ode, ex, opt, batches, device),
                         list(ex.parameters()))
    ok = step_l <= tol and step_g <= tol
    for eps, (lk, pk) in kernel_runs.items():
        ode, ex, opt = build_trainer(device, state0, True, off, eps=eps)
        lg, pg = train(ode, ex, opt, batches, device), list(ex.parameters())
        ok = runs_agree("generic loop through K1", eps, (lk, pk), (lg, pg),
                        tol) and ok
    if not ok:
        raise AssertionError("kernel path and generic path disagree")
    return kernel_runs


def runs_agree(label, eps, got, ref, tol):
    """Phase 4(a)'s form for two free-running runs (losses, params): the
    losses within ``tol`` relative; the params within ``tol`` in max abs at
    Adam eps 1e-8 and norm-wise relative at eps 1e-6. Logs, returns ok."""
    (lk, pk), (lg, pg) = got, ref
    lk, lg = lk.double().cpu(), lg.double().cpu()
    lrel = float(((lk - lg).abs() / lg.abs()).max())
    pabs = max(abs_err(a, b) for a, b in zip(pk, pg))
    prel = norm_rel(pk, pg)
    log(f"[slice]     free-running vs {label}, Adam eps {eps:.0e}: losses "
        f"max rel err {lrel:.3e}; params max abs diff {pabs:.3e}, max rel "
        f"(norm-wise per tensor) {prel:.3e}; gated: losses rel and params "
        f"{'max abs' if eps == 1e-8 else 'rel'}, tol {tol:.0e}")
    return lrel <= tol and (pabs <= tol if eps == 1e-8 else prel <= tol)


def phase_slice(device, u, n_long=200, n_plain=50):
    import torch

    from pnode_tpu_torch.models import KSFuncEX
    from pnode_tpu_torch.ops.fused_ark_adjoint import fused_ark_step_adj
    from pnode_tpu_torch.ops.fused_ark_forward import fused_ark_step_fwd
    from pnode_tpu_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_fwd

    log(f"[slice] KS data {u.shape}, batch {BATCH}, dt {DT}, lr {LR}")
    init = KSFuncEX(nx=NX, hidden=HIDDEN, use_fused=True, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
    state0 = {k: v.detach().clone() for k, v in init.state_dict().items()}
    batches = ks_batches(u, n_long, BATCH, seed=0)
    wrappers = {"fused_mlp_fwd": fused_mlp_fwd, "fused_mlp_bwd": fused_mlp_bwd,
                "fused_ark_step_fwd": fused_ark_step_fwd,
                "fused_ark_step_adj": fused_ark_step_adj}
    for w in wrappers.values():
        w.launches = 0

    kernel_runs = phase_paths_agree(device, state0, batches[:4])

    # (b) 200 iterations on the kernel path, timed after a warm-up
    ode_k, ex_k, opt_k = build_trainer(device, state0, fused=True)
    warm = 20
    loss_warm = train(ode_k, ex_k, opt_k, batches[:warm], device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_rest = train(ode_k, ex_k, opt_k, batches[warm:], device)
    torch.cuda.synchronize()
    kern_sps = (n_long - warm) / (time.perf_counter() - t0)
    counts = {k: w.launches for k, w in wrappers.items()}
    profile_steps("kernel path", ode_k, ex_k, opt_k, batches[:10], device)
    losses = torch.cat([loss_warm, loss_rest]).cpu().numpy()
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    log(f"[slice] (b) {n_long} Adam steps on the kernel path: mean loss "
        f"first 20 {first:.6e}, last 20 {last:.6e}; "
        f"{kern_sps:.1f} steps/s (steps {warm}..{n_long})")
    if not last < first:
        raise AssertionError("training did not reduce the loss")

    # the plain path: nn.Linear model on the generic loop, no kernels
    ode_p, ex_p, opt_p = build_trainer(device, to_linear_state(state0),
                                       fused=False)
    train(ode_p, ex_p, opt_p, batches[:5], device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train(ode_p, ex_p, opt_p, batches[5:5 + n_plain], device)
    torch.cuda.synchronize()
    plain_sps = n_plain / (time.perf_counter() - t0)
    profile_steps("plain path", ode_p, ex_p, opt_p, batches[:10], device)
    log(f"[slice] plain path (nn.Linear, generic stage loop): "
        f"{plain_sps:.1f} steps/s over {n_plain} steps")
    log(f"[slice] launches over phase 4 (a) + (b): {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
    counts["fused_train_loop"] = phase_fused_loop(
        device, state0, batches, kernel_runs, last, kern_sps)
    return counts, kern_sps, plain_sps


def profile_loop(make_loop, ys, tgts, kernel="train_loop_kernel",
                 attempts=2):
    """A traced call of a fresh fused loop (``make_loop()``): its wall time
    per iteration, the device's busy share of it, and the loop kernel's
    device time per iteration. A trace that holds no time for the loop
    kernel (seen once in a process that had run many traced and untraced
    phases before) is taken again; after ``attempts`` such traces the
    kernel's time per iteration comes from CUDA events around an untraced
    call, and the busy share is not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = len(ys)
    for _ in range(attempts):
        loop = make_loop()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loop.run(ys, tgts, LR)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels, busy_us = device_kernels(prof.events())
        k_us = sum(e.time_range.elapsed_us() for e in kernels
                   if kernel in e.name)
        if k_us > 0:
            log(f"[profile] fused loop: {n} traced iterations in one call, "
                f"{1e3 * wall / n:.3f} ms/iteration; device busy "
                f"{busy_us * 1e-6 / wall:.3f} of the wall time; {kernel} "
                f"{k_us / n:.1f} us/iteration")
            return
        log(f"[profile] fused loop: the trace holds no time for {kernel} "
            f"({len(kernels)} device events)")
    loop = make_loop()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    loop.run(ys, tgts, LR)
    end.record()
    end.synchronize()
    log(f"[profile] fused loop: CUDA events over an untraced call of {n} "
        f"iterations (its launch preparation included): "
        f"{start.elapsed_time(end) / n:.3f} ms/iteration; busy share not "
        f"measured")


def load_example(name):
    """examples/<name>.py as a module (ks_torch's FusedLoop is the gate and
    the state of ``--fused_loop``; train_cifar10_torch's surrogate data;
    the trainers' main())."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_fused_loop(device, state0, batches, kernel_runs, per_step_last,
                     per_step_sps, warm=20, tol=5e-4):
    """Phase 4(c): the fused-loop path (K4 through ks_torch's FusedLoop,
    the gate and state of ``examples/ks_torch.py --fused_loop``) from
    state0 on the same batches. Returns K4's launch count over its 200
    iterations."""
    import torch

    from pnode_tpu_torch.ops.fused_train_loop import fused_train_loop

    ks = load_example("ks_torch")
    as_t = lambda i: torch.tensor(  # noqa: E731
        np.stack([b[i] for b in batches]), dtype=torch.float32,
        device=device)
    ys, tgts = as_t(0), as_t(1)
    n = len(batches)

    def fresh_loop():
        ode, ex, _ = build_trainer(device, state0, fused=True)
        return ex, ks.FusedLoop(ode, ex, BATCH, DT)

    ok = True
    for eps, ref in kernel_runs.items():
        ex, loop = fresh_loop()
        losses = loop.run(ys[:4], tgts[:4], LR, eps=eps)
        loop.copy_to(ex)
        ok = runs_agree("per-step kernel path", eps,
                        (losses, list(ex.parameters())), ref, tol) and ok
    if not ok:
        raise AssertionError("fused loop and per-step kernel path disagree")
    profile_loop(lambda: fresh_loop()[1], ys[:warm], tgts[:warm])

    ex, loop = fresh_loop()
    fused_train_loop.launches = 0
    loss_warm = loop.run(ys[:warm], tgts[:warm], LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_rest = loop.run(ys[warm:], tgts[warm:], LR)
    torch.cuda.synchronize()
    sps = (n - warm) / (time.perf_counter() - t0)
    count = fused_train_loop.launches
    losses = torch.cat([loss_warm, loss_rest]).cpu().numpy()
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite fused-loop loss")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    gap = abs(last - per_step_last) / per_step_last
    log(f"[slice] (c) {n} Adam steps on the fused loop: mean loss first 20 "
        f"{first:.6e}, last 20 {last:.6e} ({gap:.3f} from (b)'s "
        f"{per_step_last:.6e}, tol 0.1); {count} launches")
    log(f"[slice] fused loop {sps:.1f} steps/s (steps {warm}..{n}, one "
        f"launch) beside the per-step kernel path's {per_step_sps:.1f} "
        f"steps/s (b), same call")
    if not (last < first and gap <= 0.1):
        raise AssertionError("the fused loop did not train as the per-step "
                             "kernel path does")
    if count <= 0:
        raise AssertionError("fused_train_loop was never launched on the "
                             "fused-loop path")
    return count


# -- phase 5 ------------------------------------------------------------------

def adaptive_step(ode, ex, y0, tgt, device, dt0):
    """(loss, gradient tensors, stats) of one adaptive solve's MSE from
    dt0; leaves the gradients in .grad."""
    import torch

    y0 = torch.as_tensor(y0, dtype=torch.float32, device=device)
    tgt = torch.as_tensor(tgt, dtype=torch.float32, device=device)
    for p in ex.parameters():
        p.grad = None
    pred, st = ode.solve(y0, np.array([0.0, DT]), dt0=dt0)
    loss = torch.mean((pred[-1] - tgt) ** 2)
    loss.backward()
    return loss.detach(), [p.grad.detach().clone()
                           for p in ex.parameters()], st


def train_adaptive(ode, ex, opt, batches, device, dt0=DT):
    """One Adam iteration per batch through the adaptive solver, each solve
    warm-started from the previous one's dt_first (bench.py's protocol),
    the first from dt0; returns (losses, per-iteration stats)."""
    import torch

    losses, stats, dtc = [], [], dt0
    for y0, tgt in batches:
        loss, _, st = adaptive_step(ode, ex, y0, tgt, device, dtc)
        opt.step()
        losses.append(loss)
        stats.append(st)
        dtc = st.dt_first
    return torch.stack(losses), stats


def decisions(stats):
    return [(s.accepted, s.rejected, int(s.completed)) for s in stats]


def phase_adaptive_paths_agree(device, state0, batches, tol=5e-4):
    """Phase 5(a): the per-step adaptive kernel path (K2 with its err
    output, K3) against the generic adaptive path (-pnode_fused_ark_adjoint
    off: the stage loop through K1, kI = J Y), each solve warm-started from
    its own path's previous dt_first.

    - At each Adam step both paths solve from the kernel path's parameters:
      equal (accepted, rejected, completed); dt_first within 1e-4 relative
      (K2's implicit kI is the difference quotient (Y - G)/(dt a_ii), whose
      rounding moves the error estimate by ~1e-5, the generic path's is J Y);
      loss and gradients within ``tol`` relative (gradients norm-wise).
    - Run free at Adam eps 1e-8 and 1e-6: phase 4(a)'s form.

    Returns the generic path's free-running runs {eps: (losses, params,
    stats)}, phase 5(c)'s reference."""
    import torch

    import pnode_tpu_torch as pt

    off = ADAPT_FLAGS + ["-pnode_fused_ark_adjoint", "off"]
    ode, ex, opt = build_trainer(device, state0, True, ADAPT_FLAGS)
    step_l = step_g = dtf = 0.0
    same = True
    losses, stats_k = [], []
    dt_k = dt_g = DT
    for y0, tgt in batches:
        pt.set_option("pnode_fused_ark_adjoint", "off")
        l_g, g_g, st_g = adaptive_step(ode, ex, y0, tgt, device, dt_g)
        pt.set_option("pnode_fused_ark_adjoint", "auto")
        l_k, g_k, st_k = adaptive_step(ode, ex, y0, tgt, device, dt_k)
        same = same and decisions([st_k]) == decisions([st_g])
        dtf = max(dtf, abs(st_k.dt_first - st_g.dt_first) / st_g.dt_first)
        step_l = max(step_l, float(abs(l_k - l_g) / abs(l_g)))
        step_g = max(step_g, max(float((a - b).norm() / b.norm())
                                 for a, b in zip(g_k, g_g)))
        opt.step()
        losses.append(l_k)
        stats_k.append(st_k)
        dt_k, dt_g = st_k.dt_first, st_g.dt_first
    log(f"[slice] (a) {len(batches)} adaptive Adam steps, per-step kernel "
        f"path vs the generic adaptive path from the same parameters: "
        f"(accepted, rejected, completed) {decisions(stats_k)} "
        f"{'equal' if same else 'DIFFER'}; dt_first max rel {dtf:.3e} (tol "
        f"1e-4); loss max rel {step_l:.3e}, gradients {step_g:.3e} (norm-"
        f"wise; tol {tol:.0e})")
    ok = same and dtf <= 1e-4 and step_l <= tol and step_g <= tol
    kernel_runs = {1e-8: (torch.stack(losses), list(ex.parameters()),
                          stats_k)}
    ode, ex, opt = build_trainer(device, state0, True, ADAPT_FLAGS, eps=1e-6)
    lk, sk = train_adaptive(ode, ex, opt, batches, device)
    kernel_runs[1e-6] = (lk, list(ex.parameters()), sk)
    generic_runs = {}
    for eps, (lk, pk, sk) in kernel_runs.items():
        ode, ex, opt = build_trainer(device, state0, True, off, eps=eps)
        lg, sg = train_adaptive(ode, ex, opt, batches, device)
        generic_runs[eps] = (lg, list(ex.parameters()), sg)
        ok = runs_agree("generic adaptive path", eps, (lk, pk),
                        generic_runs[eps][:2], tol) and ok
        ok = ok and decisions(sk) == decisions(sg)
    if not ok:
        raise AssertionError("the per-step adaptive kernel path and the "
                             "generic adaptive path disagree")
    return generic_runs


def phase_adaptive_slice(device, u, n_steps=50, warm=5):
    """Phase 5: the adaptive slice at full width (ADAPT_FLAGS): (a) the
    per-step kernel path against the generic path; (b) n_steps iterations
    on the per-step kernel path; (c) the fused adaptive loop (K5). Returns
    the launch counts of K2's err output, K3 and K5 over the phase."""
    import torch

    from pnode_tpu_torch.models import KSFuncEX
    from pnode_tpu_torch.ops.fused_ark_adjoint import fused_ark_step_adj
    from pnode_tpu_torch.ops.fused_ark_forward import (
        fused_ark_step_fwd_embedded)

    log(f"[slice] adaptive: {' '.join(ADAPT_FLAGS)}, window [0, {DT}], "
        f"batch {BATCH}, lr {LR}, dt_first warm start")
    init = KSFuncEX(nx=NX, hidden=HIDDEN, use_fused=True, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
    state0 = {k: v.detach().clone() for k, v in init.state_dict().items()}
    batches = ks_batches(u, 200, BATCH, seed=1)
    wrappers = {"fused_ark_step_fwd_embedded": fused_ark_step_fwd_embedded,
                "fused_ark_step_adj": fused_ark_step_adj}
    for w in wrappers.values():
        w.launches = 0
    generic_runs = phase_adaptive_paths_agree(device, state0, batches[:4])

    # (b) the per-step adaptive kernel path
    ode, ex, opt = build_trainer(device, state0, True, ADAPT_FLAGS)
    l_warm, s_warm = train_adaptive(ode, ex, opt, batches[:warm], device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_rest, s_rest = train_adaptive(ode, ex, opt, batches[warm:n_steps],
                                    device, s_warm[-1].dt_first)
    torch.cuda.synchronize()
    sps = (n_steps - warm) / (time.perf_counter() - t0)
    counts = {k: w.launches for k, w in wrappers.items()}
    losses = torch.cat([l_warm, l_rest]).cpu().numpy()
    trials = [s.steps for s in s_warm + s_rest]
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    log(f"[slice] (b) {n_steps} adaptive Adam steps on the per-step kernel "
        f"path: mean loss first 10 {first:.6e}, last 10 {last:.6e}; "
        f"{sps:.1f} steps/s (steps {warm}..{n_steps}); trials per iteration "
        f"mean {np.mean(trials):.2f} (min {min(trials)}, max {max(trials)}), "
        f"rejected {sum(s.rejected for s in s_warm + s_rest)}")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError("adaptive training did not reduce the loss")
    log(f"[slice] launches over phase 5 (a) + (b): {counts}")
    counts["fused_adaptive_train_loop"] = phase_fused_adaptive_loop(
        device, state0, batches, generic_runs, sps)
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the adaptive "
                                 "path")
    return counts


def phase_fused_adaptive_loop(device, state0, batches, generic_runs,
                              per_step_sps, warm=20, tol=5e-4):
    """Phase 5(c): K5 through ks_torch's FusedAdaptiveLoop (the gate and
    state of ``examples/ks_torch.py --fused_loop -ts_adapt_type basic``)
    from state0 on the same batches, against the generic adaptive path of
    (a), which takes kI = J Y as K5 does:

    - per step (phase 4(a)'s per-step form): for 4 iterations, one call of
      one iteration each, the generic path solves from the loop's
      parameters and warm-start dt: equal (accepted, rejected, completed),
      loss within ``tol`` relative, and the gradient (the loop's read from
      its Adam moments, (m' - b1 m) / (1 - b1)) within ``tol`` in relative
      L2 over all parameters, the reference's form for this comparison
      (tests/test_fused_adaptive_loop.py:251-264): per tensor (printed)
      the first layer's gradient, a sum that cancels to ~1e-7 at the KS
      init, moves by ~1e-3 when one preactivation sits at zero and the two
      paths' fp32 stage values put it on either side (measured on the CPU:
      one hidden unit carries 98% of the difference);
    - run free for 4 iterations at Adam eps 1e-8 and 1e-6 against (a)'s
      generic runs: equal decisions, losses within ``tol`` relative; the
      parameters printed in phase 4(a)'s form, not gated (check_adaptive
      says why).

    Then a traced call of 20 iterations; a warm launch of 20 and a timed
    launch of the rest. Returns K5's launch count over those two
    launches."""
    import torch

    from pnode_tpu_torch.ops.fused_adaptive_loop import (
        fused_adaptive_train_loop)

    ks = load_example("ks_torch")
    as_t = lambda i: torch.tensor(  # noqa: E731
        np.stack([b[i] for b in batches]), dtype=torch.float32,
        device=device)
    ys, tgts = as_t(0), as_t(1)
    n = len(batches)
    b1 = 0.9

    def fresh_loop():
        ode, ex, _ = build_trainer(device, state0, True, ADAPT_FLAGS)
        return ex, ks.FusedAdaptiveLoop(ode, ex, BATCH, DT)

    def row(st, i):
        return tuple(int(st[k][i]) for k in ("accepted", "rejected",
                                             "completed"))

    # per step: the generic path from the loop's parameters and dt
    _, loop = fresh_loop()
    ode_g, ex_g, _ = build_trainer(device, state0, True,
                                   ADAPT_FLAGS + ["-pnode_fused_ark_adjoint",
                                                  "off"])
    names = [name for name, _ in ex_g.named_parameters()]
    step_l = step_g = 0.0
    step_t = [0.0] * len(names)
    same = True
    for k in range(4):
        loop.copy_to(ex_g)
        l_g, g_g, st_g = adaptive_step(ode_g, ex_g, ys[k], tgts[k], device,
                                       float(loop.dt))
        m_prev = [t.clone() for t in loop.m[0] + loop.m[1]]
        l_k = loop.run(ys[k:k + 1], tgts[k:k + 1], LR)[0]
        g_flat = [(mn - b1 * mp) / (1.0 - b1)
                  for mn, mp in zip(loop.m[0] + loop.m[1], m_prev)]
        nW = len(loop.Ws)
        g_named = loop.spec["rebuild"](g_flat[:nW], g_flat[nW:])
        g_k = [g_named[name] for name in names]
        same = same and row(loop.stats, 0) == decisions([st_g])[0]
        step_l = max(step_l, float(abs(l_k - l_g) / abs(l_g)))
        flat = lambda ts: torch.cat([t.reshape(-1) for t in ts])  # noqa
        step_g = max(step_g, float((flat(g_k) - flat(g_g)).norm()
                                   / flat(g_g).norm()))
        step_t = [max(e, float((a - b).norm() / b.norm()))
                  for e, a, b in zip(step_t, g_k, g_g)]
    log(f"[slice] (c) fused adaptive loop, 4 iterations one call each, the "
        f"generic adaptive path from the loop's parameters and dt: "
        f"decisions {'equal' if same else 'DIFFERENT'}; max rel err loss "
        f"{step_l:.3e}, gradient {step_g:.3e} (L2 over all parameters; tol "
        f"{tol:.0e}); per tensor, not gated: " + ", ".join(
            f"{n.split('.')[-1]} {e:.1e}" for n, e in zip(names, step_t)))
    ok = same and step_l <= tol and step_g <= tol

    # free-running against (a)'s generic runs
    for eps, (lg, pg, sg) in generic_runs.items():
        ex, loop = fresh_loop()
        losses = loop.run(ys[:4], tgts[:4], LR, eps=eps)
        loop.copy_to(ex)
        rows = [row(loop.stats, i) for i in range(4)]
        lrel = rel_max(losses.cpu(), lg.cpu())
        pk = list(ex.parameters())
        good = rows == decisions(sg) and lrel <= tol
        log(f"[slice] (c) fused adaptive loop, first 4 iterations in one "
            f"call, Adam eps {eps:.0e}: (accepted, rejected, completed) "
            f"{rows} {'equal to' if rows == decisions(sg) else 'DIFFERENT from'}"
            f" the generic path's; losses max rel err {lrel:.3e} (tol "
            f"{tol:.0e}); parameters, not gated: max abs "
            f"{max(abs_err(a, b) for a, b in zip(pk, pg)):.3e}, rel "
            f"(norm-wise) {norm_rel(pk, pg):.3e} {'ok' if good else 'FAIL'}")
        ok = ok and good
    if not ok:
        raise AssertionError("the fused adaptive loop and the generic "
                             "adaptive path disagree")
    profile_loop(lambda: fresh_loop()[1], ys[:warm], tgts[:warm],
                 kernel="adaptive_loop_kernel")

    ex, loop = fresh_loop()
    fused_adaptive_train_loop.launches = 0
    loss_warm = loop.run(ys[:warm], tgts[:warm], LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_rest = loop.run(ys[warm:], tgts[warm:], LR)
    torch.cuda.synchronize()
    sps = (n - warm) / (time.perf_counter() - t0)
    count = fused_adaptive_train_loop.launches
    st = loop.stats
    trials = (st["accepted"] + st["rejected"]).cpu().numpy()
    losses = torch.cat([loss_warm, loss_rest]).cpu().numpy()
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    log(f"[slice] (c) {n} adaptive Adam steps on the fused adaptive loop: "
        f"mean loss first 20 {first:.6e}, last 20 {last:.6e}; {count} "
        f"launches; trials per iteration in the timed launch mean "
        f"{trials.mean():.2f} (max {int(trials.max())} of {MAX_TRIALS})")
    log(f"[slice] fused adaptive loop {sps:.1f} steps/s (steps {warm}..{n}, "
        f"one launch) beside the per-step adaptive kernel path's "
        f"{per_step_sps:.1f} steps/s (b), same call")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError("the fused adaptive loop did not train")
    return count


# -- phase 6: the CIFAR slice -------------------------------------------------

def bound(flops, byts, dtype=None):
    """(ms, "operations" | "bytes"): the least time the card could take,
    the larger of flops at the peak for ``dtype``'s operands (default fp32,
    outside the tensor cores; bf16 on them) and bytes at the memory rate
    (H100 SXM, NVIDIA's data sheet, at the 700 W limit:
    pnode_tpu_torch.utils.roofline.H100_PEAKS)."""
    import torch

    from pnode_tpu_torch.utils.roofline import H100_PEAKS, peaks_for

    peak, rate = peaks_for(H100_PEAKS, dtype or torch.float32)
    t_ops, t_bytes = 1e3 * flops / peak, 1e3 * byts / rate
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def mlp_costs(B, dims):
    """(flops, bytes) of one K1 forward and one backward call at batch B and
    widths dims, fp32: the forward reads x and the stack and writes its
    output; the backward reads x, g and the stack and writes dx and the
    gradients. Its FLOPs: the forward of layers 0..n-2 (the inputs of
    layers 1..n-1; the last layer's output is not needed) and each layer's
    dX and dW products."""
    mlp = sum(a * b for a, b in zip(dims, dims[1:]))
    params = sum(a * b + b for a, b in zip(dims, dims[1:]))
    return {
        "fused_mlp_fwd": (2 * B * mlp, 4 * (B * (dims[0] + dims[-1])
                                           + params)),
        "fused_mlp_bwd": (B * (6 * mlp - 2 * dims[-2] * dims[-1]),
                          4 * (B * (2 * dims[0] + dims[-1]) + 2 * params)),
    }


def ks_costs(tab, adaptive_report):
    """(flops, bytes) per call of K1-K3 and per iteration of K4 and K5 at
    the KS main path (B 256, 64 -> 104 x4 -> 64, ARK3's 4 stages), counted
    from the shapes: each input read once, each output written once, fp32.
    A stage is one (d, d) product (the stage inverse, or J on the explicit
    stage) and one MLP; the reverse recomputes the MLP's layer inputs (all
    but the last layer's forward) and backprops (dX and dW: 2x the forward
    MLP), as mlp_costs counts K1's backward. K5's work depends on the data: its
    timed runs' accepted and rejected trials per iteration. K4's and K5's
    flops per iteration are fused_train_loop_cost's (forward, reverse,
    Adam); their partial-sum traffic is the kernels' choice, not counted."""
    B, d, s = BATCH, NX, 4
    dims = [NX] + [HIDDEN] * 4 + [NX]
    costs = ark_costs(tab, B, dims, 8)
    fwd, rev, loop = (costs[k] for k in ("fused_ark_step_fwd",
                                         "fused_ark_step_adj",
                                         "fused_train_loop"))
    acc, rej = adaptive_report["accepted"], adaptive_report["rejected"]
    return {
        **mlp_costs(B, dims),
        **costs,
        "fused_ark_step_fwd_embedded": (fwd[0] + 2 * s * B * d,
                                        fwd[1] + 4 * B * d),
        "fused_adaptive_train_loop": (
            (acc + rej) * fwd[0] + acc * rev[0] + loop[0] - fwd[0] - rev[0],
            loop[1]),
    }


def ark_costs(tab, B, dims, K):
    """(flops, bytes) per call of K2, K3 and K12 and per iteration of K4 in
    a launch of K iterations, at batch B and widths dims (ks_costs' counts;
    K12's from fused_grad_step_cost)."""
    from pnode_tpu_torch.ops.fused_train_loop import (
        fused_grad_step_cost, fused_train_loop_cost)

    s, d = len(tab[2]), dims[0]
    mlp = sum(a * b for a, b in zip(dims, dims[1:]))
    params = sum(a * b + b for a, b in zip(dims, dims[1:]))
    fwd = (s * (2 * B * d * d + 2 * B * mlp),
           4 * (2 * B * d + 2 * d * d + params + s * B * d))
    rev = (s * (2 * B * d * d + 6 * B * mlp - 2 * B * dims[-2] * dims[-1]),
           4 * ((s + 2) * B * d + 2 * d * d + 2 * params))
    # per iteration: y and the target in, the loss out, W, m and v read and
    # written (Adam); J and the stage inverse once per launch of K
    loop = (fused_train_loop_cost(tab, B, d, dims[1:], K)[0],
            4 * (2 * B * d + 1 + 6 * params) + 4 * 2 * d * d / K)
    return {"fused_ark_step_fwd": fwd, "fused_ark_step_adj": rev,
            "fused_train_loop": loop,
            "fused_grad_step": fused_grad_step_cost(tab, B, d, dims[1:])}


def cifar_model(device, use_kernels, state=None, dtype=None):
    """SqNxt-23 ODE at full width, rk4, Nt 2: seed-0 weights or ``state``;
    ``dtype`` "bf16" for the mixed-precision model."""
    import torch

    from pnode_tpu_torch.models import SqueezeNextODE

    m = SqueezeNextODE(width_x=1.0, method="rk4", Nt=2, dtype=dtype,
                       use_kernels=use_kernels,
                       generator=torch.Generator().manual_seed(0)).to(device)
    if state is not None:
        m.load_state_dict(state)
    return m


def stage_inputs(model, x):
    """(input NCHW, ODEDynamics) of the first ODE block of each stage, from
    the model's own forward on x (module path, no gradients)."""
    import torch

    out, h = [], x.permute(0, 3, 1, 2)
    with torch.no_grad():
        for kind, mod in zip(model.kinds, model.pieces):
            if kind != "ode":
                h = mod(h)
                continue
            if not out or out[-1][1].dim != mod.dim:
                out.append((h.clone(), mod))
            ode = model._module_solver(mod, h)
            h = ode.solve(h, np.array([model.t1]),
                          params=dict(mod.named_parameters()),
                          with_adjoint=False)[0][-1]
    return out


def check_bias(name, got, ref64, scale, report, tol=1e-4):
    """Conv-bias gradients: a bias that feeds a batch-stats norm has a true
    gradient of exactly 0, so both versions return rounding noise; gated in
    absolute terms, at ``tol`` of ``scale`` (the largest |d_beta| of the
    same layers, a sum of the same cotangents without the cancellation)."""
    ea = max(float(t.abs().max()) for t in got)
    e64 = max(float(t.abs().max()) for t in ref64)
    ok = ea <= tol * scale
    log(f"[cifar]   {name} conv-bias gradients: max |kernel| {ea:.3e}, max "
        f"|plain fp64| {e64:.3e}, against {tol:.0e} x max |d_beta| "
        f"{scale:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: conv-bias gradients are not ~0")


def norm_err(a, b):
    """||a - b|| / ||b|| over the whole tensor (b the reference)."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check_grads(name, got, plain, ref64, report, tol=5e-3):
    """K7's and K9's outputs (dx or dh, dW, dgamma, dbeta) in norm-wise form:
    within ``tol`` of the plain fp32 version and of the plain version in
    fp64 (max relative and max abs printed beside). Two correct fp32
    evaluations of the chain put a few of its ~2M ReLU pre-activations on
    either side of 0 (|a| ~ 5, ulp ~ 5e-7); each such flip moves one
    element of the ReLU's cotangent by O(1), which is ~1e-2 of max|dx| at
    that element but ~6e-4 norm-wise (measured on the CPU at the stage-2
    shape, plain fp32 against plain fp64, whose function changes by 4e-9
    under 1e-7 input noise). A wrong shift, mask, tile or race moves the
    gradients by O(1e-1) norm-wise."""
    e32 = max(norm_err(a, b) for a, b in zip(got, plain))
    e64 = max(norm_err(a, b) for a, b in zip(got, ref64))
    e_plain = max(norm_err(a, b) for a, b in zip(plain, ref64))
    m32 = max(rel_err(a, b) for a, b in zip(got, plain))
    ea = max(abs_err(a, b) for a, b in zip(got, plain))
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), ea)
    ok = e32 <= tol and e64 <= tol
    log(f"[kernels]   {name}: norm-wise rel err vs plain fp32 {e32:.3e}, vs "
        f"plain fp64 {e64:.3e} (tol {tol:.0e}; plain fp32 vs fp64 "
        f"{e_plain:.3e}); max rel vs plain fp32 {m32:.3e}, max abs "
        f"{ea:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")


def check_repeat(name, first, second):
    """Two kernel calls on the same inputs: every output bitwise equal (K6-K9
    sum in fixed orders, with no atomics). An output is a tensor (K6, K8)
    or (dx, gradients) (K7, K9)."""
    import torch

    flat = lambda r: (  # noqa: E731
        [r] if isinstance(r, torch.Tensor) else [r[0]] + list(r[1]))
    ok = all(torch.equal(a, b) for a, b in zip(flat(first), flat(second)))
    log(f"[kernels]   {name}: a second call bitwise equal "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: two calls on the same inputs differ")


def sqnxt_case(label, h, mod, device, seed, report_chain, report_layer):
    """K6-K9 against their plain versions (fp32, and fp64 with fp64
    statistics) on the model's activation h (NCHW) and ODEDynamics mod;
    each also called twice, bitwise equal."""
    import torch

    from pnode_tpu_torch.ops import fused_sqnxt as fs

    f64 = torch.float64
    B, C, H, W = h.shape
    meta = fs.make_meta(C, B, H, W)
    x = h.permute(1, 0, 2, 3).reshape(C, -1).contiguous()
    flat = [t.detach().contiguous() for t in
            fs.pack_params(dict(mod.named_parameters()), meta, torch.float32)]
    flat64 = [t.double() for t in flat]
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn(C, x.shape[1], generator=gen, device=device)
    log(f"[cifar] {label}: C {C}, N {x.shape[1]} (B {B}, {H}x{W}), cdims "
        f"{meta.cdims}, single pass {meta.single_pass}, chain workspace "
        f"{fs.chain_workspace_bytes(meta) / 2**20:.1f} MiB "
        f"({'layered' if fs.gate_meta(C, B, H, W).layered else 'chain'} on "
        f"the model)")
    # K6
    out = fs.fused_sqnxt_fwd(x, flat, meta)
    torch.cuda.synchronize()
    check_repeat("fused_sqnxt_fwd", out, fs.fused_sqnxt_fwd(x, flat, meta))
    check_kernel("fused_sqnxt_fwd", [out], [fs.fused_sqnxt_plain(x, flat, meta)],
                 [fs.fused_sqnxt_plain(x.double(), flat64, meta, work=f64)],
                 1e-5, report_chain["fwd"])
    # K7
    is_b = lambda i: i % 4 == 1  # noqa: E731  the conv biases of flat
    split = lambda r: ([r[0]] + [t for i, t in enumerate(r[1]) if not is_b(i)],
                       [t for i, t in enumerate(r[1]) if is_b(i)])  # noqa
    first = fs.fused_sqnxt_bwd(x, g, flat, meta)
    torch.cuda.synchronize()
    check_repeat("fused_sqnxt_bwd", first, fs.fused_sqnxt_bwd(x, g, flat, meta))
    got = split(first)
    pl = split(fs.fused_sqnxt_bwd_plain(x, g, flat, meta))
    r64 = split(fs.fused_sqnxt_bwd_plain(x.double(), g.double(), flat64, meta,
                                         work=f64))
    check_grads("fused_sqnxt_bwd", got[0], pl[0], r64[0], report_chain["bwd"])
    dbet = max(float(t.abs().max()) for i, t in enumerate(r64[0][1:])
               if i % 3 == 2)
    check_bias("fused_sqnxt_bwd", got[1], r64[1], dbet, report_chain["bwd"])
    # K8, K9 layer by layer, on the plain chain's layer inputs
    hs, hh = [], x
    for li in range(5):
        hs.append(hh)
        hh = fs.fused_sqnxt_layer_plain(hh, fs._layer(flat, li), meta, li)
    outs = [[], [], []]
    bw = [[[], [], []], [[], [], []]]
    repeats = []
    for li in range(5):
        lf, lf64 = fs._layer(flat, li), fs._layer(flat64, li)
        outs[0].append(fs.fused_sqnxt_layer_fwd(hs[li], lf, meta, li))
        repeats.append((outs[0][-1],
                        fs.fused_sqnxt_layer_fwd(hs[li], lf, meta, li)))
        outs[1].append(fs.fused_sqnxt_layer_plain(hs[li], lf, meta, li))
        outs[2].append(fs.fused_sqnxt_layer_plain(hs[li].double(), lf64, meta,
                                                  li, work=f64))
        gl = torch.randn(meta.cdims[li + 1], x.shape[1], generator=gen,
                         device=device)
        kern = fs.fused_sqnxt_layer_bwd(hs[li], gl, lf, meta, li)
        repeats.append((kern, fs.fused_sqnxt_layer_bwd(hs[li], gl, lf, meta,
                                                       li)))
        for k, r in enumerate((
                kern,
                fs.fused_sqnxt_layer_bwd_plain(hs[li], gl, lf, meta, li),
                fs.fused_sqnxt_layer_bwd_plain(hs[li].double(), gl.double(),
                                               lf64, meta, li, work=f64))):
            bw[0][k] += [r[0], r[1][0], r[1][2], r[1][3]]
            bw[1][k].append(r[1][1])
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(repeats):
        check_repeat(f"fused_sqnxt_layer_{('fwd', 'bwd')[k % 2]} layer "
                     f"{k // 2}", a, b)
    check_kernel("fused_sqnxt_layer_fwd (5 layers)", *outs, 1e-5,
                 report_layer["fwd"])
    check_grads("fused_sqnxt_layer_bwd (5 layers)", *bw[0],
                report_layer["bwd"])
    dbet = max(float(t.abs().max()) for t in bw[0][2][3::4])
    check_bias("fused_sqnxt_layer_bwd", bw[1][0], bw[1][2], dbet,
               report_layer["bwd"])
    return x, g, flat, meta, hs


def check_short_scratch(x, g, flat, meta):
    """K6's and K7's C entry points refuse scratch one float short of their
    plan (cudaErrorInvalidValue, 1), before they launch."""
    import torch

    from pnode_tpu_torch.ops import _build
    from pnode_tpu_torch.ops import fused_sqnxt as fs

    lis = list(range(5))
    flats = [fs._layer(flat, li) for li in lis]
    lib = _build.library()
    grid, floats, ints = fs.fwd_plan(meta, lis, x.device)
    out = torch.empty_like(x)
    scratch = torch.empty(floats, device=x.device)
    rc6 = lib.pnode_sqnxt_fwd(
        x.data_ptr(), out.data_ptr(), 5, ints,
        fs._ptrs([t.data_ptr() for lf in flats for t in lf]), meta.n_real,
        meta.H, meta.W, scratch.data_ptr(), floats - 1, grid,
        _build.stream_of(x))
    log(f"[kernels]   fused_sqnxt_fwd with scratch one float short of "
        f"{floats}: rc {rc6} {'ok' if rc6 == 1 else 'FAIL'}")
    grid, floats = fs.bwd_plan(meta, lis, x.device)
    zs = [torch.empty(meta.cdims[li + 1], meta.n_real, device=x.device)
          for li in lis]
    grads = [tuple(torch.empty_like(t) for t in lf) for lf in flats]
    ints, ptrs = fs._layer_args(meta, lis, flats, zs, grads)
    dx = torch.empty_like(x)
    scratch = torch.empty(floats, device=x.device)
    rc7 = lib.pnode_sqnxt_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), 5, ints, ptrs,
        meta.n_real, meta.H, meta.W, scratch.data_ptr(), floats - 1, grid,
        _build.stream_of(x))
    log(f"[kernels]   fused_sqnxt_bwd with scratch one float short of "
        f"{floats}: rc {rc7} {'ok' if rc7 == 1 else 'FAIL'}")
    if rc6 != 1 or rc7 != 1:
        raise AssertionError("K6 or K7 took a scratch of the wrong size")


def time_sqnxt(label, h, mod, x, g, flat, meta, hs, reports):
    """Per evaluation, in turns: K6 (chain) and K8 (five layer launches)
    beside their plain versions and beside the module path's evaluation
    (F.conv2d + BatchStatsNorm + ReLU per layer, no gradients); K7 and K9
    beside their plain versions and the module path's forward + autograd
    backward."""
    import torch

    from pnode_tpu_torch.ops import fused_sqnxt as fs

    hg = h.detach().clone().requires_grad_(True)
    g_nchw = g.reshape(meta.cdims[5], *[h.shape[0], h.shape[2], h.shape[3]])
    g_nchw = g_nchw.permute(1, 0, 2, 3).contiguous()
    params = list(mod.parameters())
    gls = [g[:meta.cdims[li + 1]].contiguous() for li in range(5)]

    def module_fwd():
        with torch.no_grad():
            mod(0.0, h)

    def module_bwd():
        torch.autograd.grad(mod(0.0, hg), [hg] + params, g_nchw)

    def layers(fn):
        return lambda: [fn(hs[li], fs._layer(flat, li), meta, li)
                        for li in range(5)]

    def layers_bwd(fn):
        return lambda: [fn(hs[li], gls[li], fs._layer(flat, li), meta, li)
                        for li in range(5)]

    # (kernel, plain, module path, (flops, bytes), launches per evaluation,
    # the kernel's name in a trace): the layered rows' bound counts each
    # launch's own input and output (sqnxt_layered_cost)
    chain = range(5)
    rows = {
        "fused_sqnxt_fwd": (lambda: fs.fused_sqnxt_fwd(x, flat, meta),
                            lambda: fs.fused_sqnxt_plain(x, flat, meta),
                            module_fwd, fs.sqnxt_cost(meta, chain, False), 1,
                            "sqnxt_fwd_kernel"),
        "fused_sqnxt_bwd": (lambda: fs.fused_sqnxt_bwd(x, g, flat, meta),
                            lambda: fs.fused_sqnxt_bwd_plain(x, g, flat, meta),
                            module_bwd, fs.sqnxt_cost(meta, chain, True), 1,
                            "sqnxt_bwd_kernel"),
        "fused_sqnxt_layer_fwd": (layers(fs.fused_sqnxt_layer_fwd),
                                  layers(fs.fused_sqnxt_layer_plain),
                                  module_fwd,
                                  fs.sqnxt_layered_cost(meta, False), 5,
                                  "sqnxt_fwd_kernel"),
        "fused_sqnxt_layer_bwd": (layers_bwd(fs.fused_sqnxt_layer_bwd),
                                  layers_bwd(fs.fused_sqnxt_layer_bwd_plain),
                                  module_bwd,
                                  fs.sqnxt_layered_cost(meta, True), 5,
                                  "sqnxt_bwd_kernel"),
    }
    out = {}
    for name, (kern, plain, module, (flops, byts), per_call,
               kname) in rows.items():
        t = [summary(cuda_times_ms(f, reps=10, warmup=2, inner=5))[0]
             for f in (plain, kern, module, kern, plain, module)]
        b_ms, b_by = bound(flops, byts)
        # the profiler's device time beside the CUDA events
        us, traced = device_us_per_call(kern, [kname], per_call=[per_call])
        out[name] = dict(ms=min(t[1], t[3]), plain_ms=min(t[0], t[4]),
                         module_ms=min(t[2], t[5]), bound_ms=b_ms,
                         bound_by=b_by, device_ms=us / 1e3)
        log(f"[cifar]   {label} {name} per evaluation: kernel {t[1]:.4f} / "
            f"{t[3]:.4f} ms, device {us / 1e3:.4f} ms ({traced} launches "
            f"traced), plain {t[0]:.4f} / {t[4]:.4f} ms, module path "
            f"{t[2]:.4f} / {t[5]:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{flops / 1e9:.3f} GFLOP, {byts / 1e6:.2f} MB); medians of 10 "
            f"samples of 5 back-to-back calls")
    reports[label] = out


def phase_sqnxt_kernels(device, x):
    """Phase 6(a): K6-K9 on the model's stage activations at the three
    full-width ODE stage shapes (B 128) in both modes, and a ragged shape
    (B 3, 5x7, dim 16 on 16 channels of a stage-1 activation); timed at the
    stage shapes."""
    import torch

    from pnode_tpu_torch.models.sqnxt import ODEDynamics, _lecun_normal_

    model = cifar_model(device, "off")
    stages = stage_inputs(model, x)
    reports = {k: {} for k in SQNXT_KERNELS}
    timed = {}
    for si, (h, mod) in enumerate(stages):
        label = f"stage {si + 1}"
        rep_c = {"fwd": {}, "bwd": {}}
        rep_l = {"fwd": {}, "bwd": {}}
        case = sqnxt_case(label, h, mod, device, 10 + si, rep_c, rep_l)
        for name, r in (("fused_sqnxt_fwd", rep_c["fwd"]),
                        ("fused_sqnxt_bwd", rep_c["bwd"]),
                        ("fused_sqnxt_layer_fwd", rep_l["fwd"]),
                        ("fused_sqnxt_layer_bwd", rep_l["bwd"])):
            reports[name]["max_abs_err"] = max(
                reports[name].get("max_abs_err", 0.0), r["max_abs_err"])
        time_sqnxt(label, h, mod, *case, timed)
    # K6-K9 at the edges of their tiling (SQNXT_EDGES), each on a
    # slice of a stage's activation with a lecun-normal ODEDynamics
    gen = torch.Generator().manual_seed(1)
    for k, (label, si, dim, B, H, W) in enumerate(SQNXT_EDGES):
        edge = ODEDynamics(dim)
        for conv in edge.convs:
            w = conv.weight
            _lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], gen)
        edge = edge.to(device)
        h1 = stages[si][0]
        h1 = h1.repeat(-(-B // h1.shape[0]), 1, 1, 1)[:B, :dim, :H, :W]
        h1 = h1.contiguous()
        case = sqnxt_case(label, h1, edge, device, 20 + k,
                          {"fwd": {}, "bwd": {}}, {"fwd": {}, "bwd": {}})
        if k == 0:
            check_short_scratch(*case[:4])
    # the JSON line's times: K6/K7 at stage 2 (the larger of the chain's
    # shapes), K8/K9 at stage 1 (the layered mode's only stage); every
    # stage's times are in the log above
    for name, label in (("fused_sqnxt_fwd", "stage 2"),
                        ("fused_sqnxt_bwd", "stage 2"),
                        ("fused_sqnxt_layer_fwd", "stage 1"),
                        ("fused_sqnxt_layer_bwd", "stage 1")):
        reports[name].update(timed[label][name])
    for name in ("fused_sqnxt_fwd", "fused_sqnxt_bwd"):
        reports[name]["stage3"] = timed["stage 3"][name]
    return reports


def cifar_step(model, opt, x, y):
    import torch

    logits = model(x, training=True)
    loss = torch.nn.functional.cross_entropy(logits, y)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def grads_of(model, x, y):
    import torch

    model.zero_grad(set_to_none=True)
    logits = model(x, training=True)
    loss = torch.nn.functional.cross_entropy(logits, y)
    loss.backward()
    g = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    return logits.detach(), float(loss.detach()), g.double()


def compare_paths(label, m_on, m_off, x, y):
    """The kernel path against the module path at the same weights on one
    batch: logits, loss, and the whole gradient's cosine and norm ratio
    (CIFAR_TOL; the tolerances and their reasons in PERF.md). Logs the
    reading and returns whether it is within them."""
    lo_on, l_on, g_on = grads_of(m_on, x, y)
    lo_off, l_off, g_off = grads_of(m_off, x, y)
    e_logit = rel_err(lo_on, lo_off)
    e_loss = abs(l_on - l_off) / abs(l_off)
    cos = float(g_on @ g_off / (g_on.norm() * g_off.norm()))
    ratio = float(g_on.norm() / g_off.norm())
    ok = (e_logit <= CIFAR_TOL["logits"] and e_loss <= CIFAR_TOL["loss"]
          and cos >= CIFAR_TOL["cos"]
          and abs(ratio - 1.0) <= CIFAR_TOL["ratio"])
    log(f"[cifar] {label}: logits rel {e_logit:.3e} (tol "
        f"{CIFAR_TOL['logits']:.0e}), loss {l_on:.6f} vs {l_off:.6f} rel "
        f"{e_loss:.3e} (tol {CIFAR_TOL['loss']:.0e}), gradient cosine "
        f"{cos:.6f} (tol {CIFAR_TOL['cos']}), norm ratio {ratio:.6f} (tol 1 "
        f"+- {CIFAR_TOL['ratio']}) {'ok' if ok else 'FAIL'}")
    return ok


def phase_cifar_paths_agree(device, x, y, state0):
    """Phase 6(b): the kernel path against the module path from the same
    weights on one surrogate batch."""
    if not compare_paths(f"(b) kernel path vs module path, B {CIFAR_B}, "
                         "seed-0 weights", cifar_model(device, "on", state0),
                         cifar_model(device, "off", state0), x, y):
        raise AssertionError("the CIFAR kernel and module paths disagree")


def phase_cifar_stepwise(device, state0, batches, x_tr, y_tr, n_steps=2):
    """6(c), first: the kernel path's SGD trajectory (6(c)'s optimizer and
    batches) held against the module path step by step: after each of
    its first ``n_steps`` steps, the module path at the kernel path's
    weights, on the next batch, as 6(b). The two paths' own trajectories
    part from the first step on, each as far from the fp64 truth's as
    from the other's (fp32 rounding amplified by the first steps from the
    seed-0 weights; PERF.md), so their losses are compared at the same
    weights, not along their own trajectories."""
    import torch

    m_on = cifar_model(device, "on", state0)
    m_off = cifar_model(device, "off", state0)
    opt = torch.optim.SGD(m_on.parameters(), lr=CIFAR_LR, momentum=0.9,
                          weight_decay=5e-4)
    ok = True
    for t in range(1, n_steps + 1):
        grads_of(m_on, x_tr[batches[t - 1]], y_tr[batches[t - 1]])
        opt.step()
        m_off.load_state_dict(m_on.state_dict())
        ok = compare_paths(f"(c) after SGD step {t} of the kernel path",
                           m_on, m_off, x_tr[batches[t]],
                           y_tr[batches[t]]) and ok
    if not ok:
        raise AssertionError("the CIFAR kernel and module paths disagree "
                             "along the kernel path's trajectory")


def train_cifar(label, model, batches, x_tr, y_tr, warm):
    """SGD (lr 0.1, momentum 0.9, wd 5e-4) over ``batches``: the losses,
    images/s over the iterations after ``warm``, and the peak device
    memory of the run."""
    import torch

    opt = torch.optim.SGD(model.parameters(), lr=CIFAR_LR, momentum=0.9,
                          weight_decay=5e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for k, idx in enumerate(batches):
        if k == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(cifar_step(model, opt, x_tr[idx], y_tr[idx]))
    torch.cuda.synchronize()
    ips = (len(batches) - warm) * CIFAR_B / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack(losses).cpu().numpy()
    log(f"[cifar] (c) {label}: {len(batches)} SGD iterations, losses "
        f"{np.array2string(losses, precision=4, max_line_width=200)}; "
        f"{ips:.1f} images/s over iterations {warm}..{len(batches)}; peak "
        f"device memory {peak:.3f} GB (max_memory_allocated)")
    return losses, ips, peak, opt


def profile_cifar(label, model, opt, x, y):
    """One traced iteration: the device's busy share and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cifar_step(model, opt, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, busy_us = device_kernels(prof.events())
    per = {}
    for e in kernels:
        us, n = per.get(e.name, (0.0, 0))
        per[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    log(f"[profile] CIFAR {label}: one traced iteration {1e3 * wall:.1f} ms; "
        f"device busy {busy_us * 1e-6 / wall:.3f} of the wall time; kernel "
        f"time {busy_us / 1e3:.1f} ms")
    for name, (us, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile]   {us / 1e3:9.3f} ms x{n:<5d} {name[:90]}")
    # K6-K9 (sqnxt_fwd_kernel<5>/<1>, sqnxt_bwd_kernel<5>/<1>): their
    # milliseconds in the iteration and their shares of its wall time and
    # of the device's busy time
    for name, (us, n) in sorted(per.items()):
        if "sqnxt_fwd_kernel" in name or "sqnxt_bwd_kernel" in name:
            log(f"[profile]   CIFAR {label} {name[:100]}: "
                f"{us / 1e3:.3f} ms per iteration over {n} launches, "
                f"{us * 1e-6 / wall:.3f} of the traced wall time, "
                f"{us / busy_us:.3f} of the busy time")


def phase_cifar(device, n_iters=12, warm=2, n_off=6):
    """Phase 6: the CIFAR slice at full width, batch 128, rk4, Nt 2."""
    import torch

    from pnode_tpu_torch.ops import fused_sqnxt as fs

    cif = load_example("train_cifar10_torch")
    x_np, y_np, _, _, synthetic = cif.load_cifar10(
        os.path.join(ROOT, "data", "cifar-10-batches-py"))
    x_tr = torch.as_tensor(x_np, device=device)
    y_tr = torch.as_tensor(y_np, device=device).long()
    rng = np.random.default_rng(0)
    batches = [torch.as_tensor(rng.choice(len(x_np), CIFAR_B, replace=False),
                               device=device) for _ in range(n_iters)]
    log(f"[cifar] data {tuple(x_np.shape)} ({'synthetic surrogate' if synthetic else 'CIFAR-10'}), "
        f"SqNxt-23 ODE width 1.0, rk4, Nt 2, batch {CIFAR_B}")
    reports = phase_sqnxt_kernels(device, x_tr[batches[0]])
    state0 = {k: v.detach().clone()
              for k, v in cifar_model(device, "off").state_dict().items()}
    phase_cifar_paths_agree(device, x_tr[batches[0]], y_tr[batches[0]],
                            state0)

    wrappers = [fs.fused_sqnxt_fwd, fs.fused_sqnxt_bwd,
                fs.fused_sqnxt_layer_fwd, fs.fused_sqnxt_layer_bwd]
    # cuDNN's default fp32 weight-gradient algorithms for the non-ODE convs
    # add by atomics: without its deterministic ones the loss sequence,
    # and the gate below, changed from run to run
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        phase_cifar_stepwise(device, state0, batches, x_tr, y_tr)
        m_on = cifar_model(device, "on", state0)
        for w in wrappers:
            w.launches = 0
        losses, ips_on, peak_on, opt = train_cifar(
            "kernel path", m_on, batches, x_tr, y_tr, warm)
        counts = {w.__name__: w.launches for w in wrappers}
        log(f"[cifar] (c) launches over the kernel path's {n_iters} "
            f"iterations: {counts} (per iteration: "
            f"{ {k: v / n_iters for k, v in counts.items()} })")
        profile_cifar("kernel path", m_on, opt, x_tr[batches[0]],
                      y_tr[batches[0]])
        m_off = cifar_model(device, "off", state0)
        _, ips_off, peak_off, opt_off = train_cifar(
            "module path", m_off, batches[:n_off], x_tr, y_tr, warm)
        profile_cifar("module path", m_off, opt_off, x_tr[batches[0]],
                      y_tr[batches[0]])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"[cifar] (c) images/s: kernel path {ips_on:.1f}, module path "
        f"{ips_off:.1f}; memstat peak GB: kernel path {peak_on:.3f}, module "
        f"path {peak_off:.3f}")
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"CIFAR training did not lower the loss (first "
                             f"5 {first:.4f}, last 5 {last:.4f})")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the CIFAR "
                                 "path")
    return reports, counts, ips_on


# -- phase 7: the Burgers slice -----------------------------------------------

def stencil_case(device, rows, n, k, seed):
    """y and g, N(0, 1), and random asymmetric taps U(-1, 1), fp32 on
    ``device`` (both fixed stencils are symmetric: a reversed tap order or
    a roll in the wrong direction passes on them unseen)."""
    import torch

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    return (f32(rng.normal(size=(rows, n))), f32(rng.normal(size=(rows, n))),
            f32(rng.uniform(-1.0, 1.0, size=k)))


def circulant(w, n):
    """The dense (n, n) C with (y @ C.T)[i] = sum_j w[j] y[(i + j - k//2)
    mod n], in fp32, each entry's taps added in j order (as K10 adds them
    when k > n)."""
    C = np.zeros((n, n), np.float32)
    k = len(w)
    for i in range(n):
        for j in range(k):
            C[i, (i + j - k // 2) % n] += w[j]
    return C


def stencil_cost(rows, n, k, need_dw=True):
    """(flops, bytes) of K10 and K11 at (rows, n), k taps, fp32, each input
    read once, each output written once: K11 as dy alone (g and w in, dy
    out) or, with ``need_dw``, dy and dw (y, g and w in, dy and dw out)."""
    e = rows * n
    return {"circular_stencil_fwd": (2 * k * e, 4 * (2 * e + k)),
            "circular_stencil_bwd": ((4 if need_dw else 2) * k * e,
                                     4 * ((3 if need_dw else 2) * e
                                          + (2 if need_dw else 1) * k))}


def device_us_per_call(fn, names, n=20, per_call=None, tries=4):
    """(device us per call, launches traced) of the kernels whose names hold
    one of ``names`` (``per_call`` launches of each per call, default one),
    from a trace of ``n`` calls: the mean over the traced launches of each,
    times its launches per call, summed. A trace may miss launches, and
    now and then all of one kernel's: then it traces again, up to
    ``tries`` traces. CUDA events time what a caller of back-to-back calls
    waits for, which is the host's launch cost when that is the slower
    side."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels, _ = device_kernels(prof.events())
        found = [[e.time_range.elapsed_us() for e in kernels if part in e.name]
                 for part in names]
        if all(found):
            break
    total = sum(k * sum(us) / len(us) if us else float("nan")
                for us, k in zip(found, per_call or [1] * len(names)))
    return total, sum(len(us) for us in found)


def single_call_ms(fn, n=10):
    """Median device ms of one call of ``fn`` between two CUDA events, the
    stream held busy (torch.cuda._sleep) while the host enqueues the
    events and the call, so the events time the call's kernels and not its
    launch: the device time where a profiler trace holds none of them."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_stencil(label, y, g, w):
    """Per call, in turns (plain, kernel, library, kernel, plain, library):
    K10 beside its plain version and nn.Conv1d(1, 1, k, padding k//2,
    circular, no bias) with cuDNN's TF32 off (the library call for the same
    function, which the port never makes); K11 without dw (the main path's
    mode, a fixed stencil) beside its plain version and that conv's
    backward to its input alone, and K11 with dw beside the conv's backward
    to input and weight (autograd.grad over a retained graph). The device
    time per call of each (the profiler) and the launch floor, a
    one-element torch.add's device time, by the same helper. The conv's
    forward + backward is logged beside them."""
    import torch

    from pnode_tpu_torch.ops import circular_stencil as cs

    if torch.backends.cudnn.allow_tf32:
        raise AssertionError("cuDNN TF32 is on: the port turns it off")
    k = int(w.shape[0])
    conv = torch.nn.Conv1d(1, 1, k, padding=k // 2, padding_mode="circular",
                           bias=False, device=y.device)
    with torch.no_grad():
        conv.weight.copy_(w.reshape(1, 1, k))
        lib_err = rel_err(conv(y[:, None])[:, 0],
                          cs.circular_stencil_plain(y, w))
    if lib_err > 1e-5:
        raise AssertionError(f"nn.Conv1d is not the stencil ({lib_err:.3e})")
    x = y[:, None].clone().requires_grad_(True)
    g3 = g[:, None]
    graph = conv(x)

    def lib_fwd():
        with torch.no_grad():
            conv(y[:, None])

    def lib_bwd(wrt):
        return lambda: torch.autograd.grad(graph, wrt, g3, retain_graph=True)

    def lib_both():
        torch.autograd.grad(conv(x), (x, conv.weight), g3)

    rows = {
        "circular_stencil_fwd": (lambda: cs.circular_stencil_fwd(y, w),
                                 lambda: cs.circular_stencil_plain(y, w),
                                 lib_fwd, "stencil_fwd"),
        "circular_stencil_bwd": (
            lambda: cs.circular_stencil_bwd(y, g, w, need_dw=False),
            lambda: cs.circular_stencil_bwd_plain(y, g, w, need_dw=False),
            lib_bwd((x,)), "stencil_bwd"),
        "circular_stencil_bwd with dw": (
            lambda: cs.circular_stencil_bwd(y, g, w),
            lambda: cs.circular_stencil_bwd_plain(y, g, w),
            lib_bwd((x, conv.weight)), "stencil_bwd"),
    }
    one = torch.ones(1, device=y.device)
    floor_us, _ = device_us_per_call(lambda: torch.add(one, one), [""])
    log(f"[burgers]   {label} launch floor: a one-element torch.add takes "
        f"{floor_us:.2f} us on the device")
    out = {}
    for name, (kern, plain, lib, part) in rows.items():
        t = [summary(cuda_times_ms(f))[0]
             for f in (plain, kern, lib, kern, plain, lib)]
        us, n = device_us_per_call(kern, [part])
        out[name] = dict(ms=min(t[1], t[3]), plain_ms=min(t[0], t[4]),
                         library_ms=min(t[2], t[5]), device_ms=us / 1e3,
                         launch_floor_device_ms=floor_us / 1e3)
        log(f"[burgers]   {label} {name}: kernel {t[1]:.4f} / {t[3]:.4f} ms, "
            f"plain {t[0]:.4f} / {t[4]:.4f} ms, nn.Conv1d {t[2]:.4f} / "
            f"{t[5]:.4f} ms; medians of 30 samples of 10 back-to-back calls; "
            f"device time {us:.2f} us per call ({n} kernel launches traced "
            f"over 20 calls), {us / floor_us:.2f}x the launch floor")
    both = summary(cuda_times_ms(lib_both))[0]
    log(f"[burgers]   {label} nn.Conv1d forward + backward {both:.4f} ms "
        f"(its output vs the roll chain: rel err {lib_err:.3e})")
    return out


def trace_stencil_launches(device, y, g, w, n=20):
    """Each K10 call and each K11 call, in both modes, launches its stencil
    kernel and no other (no fill, no cast, no second pass), over a trace of
    ``n`` calls; so does each forward and backward of the Burgers implicit
    part (BurgersFuncIM's fixed stencil in fp64, used in y's fp32) on the
    main path's route: the autograd Function through the module. A trace
    may miss launches (the earlier phases' traces show it too), so it must
    hold at least one launch of each expected kernel (tracing again, up to
    4 times, until it does), at most one per call, and nothing else."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pnode_tpu_torch.models import BurgersFuncIM
    from pnode_tpu_torch.ops import circular_stencil as cs

    f_im = BurgersFuncIM(nx=y.shape[1], use_fused=True, device=device)
    yr = y.clone().requires_grad_(True)

    def module_call():
        out = f_im(0.0, yr)
        torch.autograd.grad(out, yr, g)

    calls = (("K10", lambda: cs.circular_stencil_fwd(y, w), ["stencil_fwd"]),
             ("K11 without dw",
              lambda: cs.circular_stencil_bwd(y, g, w, need_dw=False),
              ["stencil_bwd"]),
             ("K11 with dw", lambda: cs.circular_stencil_bwd(y, g, w),
              ["stencil_bwd"]),
             ("BurgersFuncIM forward + backward", module_call,
              ["stencil_fwd", "stencil_bwd"]))
    for label, fn, want in calls:
        fn()
        torch.cuda.synchronize()
        for _ in range(4):  # a trace now and then drops every launch
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            kernels, _ = device_kernels(prof.events())
            names = [e.name.split("(")[0] for e in kernels]
            counts = {part: sum(part in name for name in names)
                      for part in want}
            if all(counts.values()):
                break
        log(f"[burgers]   trace of {n} calls, {label}: {len(names)} device "
            f"kernels traced, {sorted(set(names))}")
        if not (all(0 < c <= n for c in counts.values())
                and sum(counts.values()) == len(names)):
            raise AssertionError(f"{label}: not one stencil kernel per "
                                 f"launch and nothing else ({names})")


def phase_stencil_kernels(device):
    """Phase 7(a), K10 and K11: against their plain versions in fp32 and
    fp64 at STENCIL_CASES' shapes with random asymmetric taps (forward <=
    1e-6 of max |ref|, the same sums in the same order; dy and dw <= 1e-5,
    dw's sums in another order; fp64 <= 1e-4); K10's output and K11's dy
    bitwise equal to the plain fp32 version's; K11 without its dw pass
    gives the same dy; two K11 calls give the same dw bitwise (the last
    block's ordered sum); the autograd Function with a learnable stencil
    runs K10/K11; torch.func.jacfwd through K10 (its jvp and vmap rules)
    equals the dense circulant exactly; one device kernel per call in
    every mode; times at the Burgers and KS shapes, K11 in both modes."""
    import torch

    from pnode_tpu_torch.ops import circular_stencil as cs

    reports = {name: {} for name in STENCIL_KERNELS}
    for si, (label, rows, n, k) in enumerate(STENCIL_CASES):
        y, g, w = stencil_case(device, rows, n, k, 70 + si)
        y64, g64, w64 = y.double(), g.double(), w.double()
        log(f"[burgers] K10/K11 at the {label} shape ({rows}, {n}), k {k}, "
            f"taps {np.array2string(w.cpu().numpy(), precision=4)}")
        out = cs.circular_stencil_fwd(y, w)
        torch.cuda.synchronize()
        plain = cs.circular_stencil_plain(y, w)
        check_kernel("circular_stencil_fwd", [out], [plain],
                     [cs.circular_stencil_plain(y64, w64)], 1e-6,
                     reports["circular_stencil_fwd"])
        dy, dw = cs.circular_stencil_bwd(y, g, w)
        dy_only, no_dw = cs.circular_stencil_bwd(y, g, w, need_dw=False)
        dy_again, dw_again = cs.circular_stencil_bwd(y, g, w)
        torch.cuda.synchronize()
        plain_dy = cs.circular_stencil_bwd_plain(y, g, w)
        check_kernel("circular_stencil_bwd", [dy, dw], list(plain_dy),
                     list(cs.circular_stencil_bwd_plain(y64, g64, w64)),
                     1e-5, reports["circular_stencil_bwd"])
        same = (bool(torch.equal(out, plain)),
                bool(torch.equal(dy, plain_dy[0])))
        log(f"[kernels]   bitwise equal to the plain fp32 version: forward "
            f"{same[0]}, dy {same[1]}; a second K11 call's dw "
            f"{'equals' if torch.equal(dw, dw_again) else 'DIFFERS FROM'} "
            "the first bitwise")
        if not all(same):
            raise AssertionError("K10's output or K11's dy is not the roll "
                                 "chain's, bitwise")
        if no_dw is not None or not torch.equal(dy_only, dy):
            raise AssertionError("K11 without its dw pass changed dy")
        if not (torch.equal(dw, dw_again) and torch.equal(dy, dy_again)):
            raise AssertionError("two K11 calls differ")
        yr = y.clone().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        cs.circular_stencil(yr, wr).backward(g)
        if not (torch.equal(yr.grad, dy) and torch.equal(wr.grad, dw)):
            raise AssertionError("circular_stencil's backward is not K11")
        if n <= 1024:
            J = torch.func.jacfwd(lambda r: cs.circular_stencil(r, w))(
                y[0].clone())
            exact = bool(torch.equal(J, torch.tensor(
                circulant(w.cpu().numpy(), n), device=device)))
            log(f"[kernels]   torch.func.jacfwd through K10 at N {n}: "
                f"{'equals' if exact else 'DIFFERS FROM'} the dense "
                "circulant")
            if not exact:
                raise AssertionError("jacfwd through K10 is not the "
                                     "circulant")
        if si == 0:
            trace_stencil_launches(device, y, g, w)
        if si < 2:
            times = time_stencil(label, y, g, w)
            for name in STENCIL_KERNELS:
                costs = {False: stencil_cost(rows, n, k, False)[name],
                         True: stencil_cost(rows, n, k, True)[name]}
                row = times[name]
                row["bound_ms"], row["bound_by"] = bound(*costs[False])
                if name == "circular_stencil_bwd":
                    dw_row = times[name + " with dw"]
                    dw_row["bound_ms"], dw_row["bound_by"] = bound(
                        *costs[True])
                    row["with_dw"] = dw_row
                for r, mode in ((row, ""), (row.get("with_dw"), " with dw")):
                    if r:
                        log(f"[burgers]   {label} {name}{mode} bound "
                            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
                if si == 0:  # the Burgers stage: the JSON line's shape
                    reports[name].update(row)
                else:
                    reports[name]["ks_stage"] = row
    return reports


def phase_burgers_mlp(device, state0):
    """Phase 7(a), K1 at the Burgers stack (B 200, 512 -> 576 x4 -> 512,
    seed-0 weights, bench.py's N(0, 1) states): its scratch; the forward
    against the plain fp32 and fp64 versions (1e-5 and 1e-4 of max |ref|,
    as at KS), the backward norm-wise (check_grads, 5e-3): at these widths
    460,800 ReLU pre-activations of std 2-10 put some within fp32 rounding
    of 0, and such a unit flips between two correct fp32 evaluations (on
    these inputs layer 3's unit 381 at row 144, |z| 9.8e-7 in fp64, moved
    dx, dW and db 1.2e-3 to 1.6e-3 norm-wise and 1.5e-2 max relative, all in
    that row's backprop); a second backward equal bitwise; the device memory
    one backward allocates; times in turns with the plain version (the
    cuBLAS chain). Returns the JSON line's ``burgers`` entries of K1."""
    import torch

    from pnode_tpu_torch.ops.fused_mlp import (
        fused_mlp_bwd, fused_mlp_bwd_plain, fused_mlp_fwd, fused_mlp_plain,
        grad_buffer_size, mlp_scratch)

    n = 5
    Ws = [state0[f"net.kernel_{i}"] for i in range(n)]
    bs = [state0[f"net.bias_{i}"] for i in range(n)]
    dims = [BNX] + [int(W.shape[1]) for W in Ws]
    fwd_scratch, bwd_scratch = mlp_scratch(tuple(dims), BB)
    log(f"[burgers] K1 at the Burgers stack {dims}, B {BB}: scratch forward "
        f"{4 * fwd_scratch / 1e6:.3f} MB, backward {4 * bwd_scratch / 1e6:.3f}"
        " MB; no partial sums")
    rng = np.random.default_rng(7)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa
    x, g = f32(rng.normal(size=(BB, BNX))), f32(rng.normal(size=(BB, BNX)))
    f64 = lambda ts: [t.double() for t in ts]  # noqa: E731
    out = fused_mlp_fwd(x, Ws, bs)
    torch.cuda.synchronize()
    check_kernel("fused_mlp_fwd (Burgers)", [out], [fused_mlp_plain(x, Ws, bs)],
                 [fused_mlp_plain(x.double(), f64(Ws), f64(bs))], 1e-5, {})
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = fused_mlp_bwd(x, g, Ws, bs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    outputs = 4 * (BB * BNX + grad_buffer_size(dims))
    log(f"[burgers]   K1 backward allocates {peak / 1e6:.3f} MB of device "
        f"memory: outputs {outputs / 1e6:.3f} MB, scratch "
        f"{4 * bwd_scratch / 1e6:.3f} MB")
    flat = lambda r: [r[0], *r[1], *r[2]]  # noqa: E731
    plain = fused_mlp_bwd_plain(x, g, Ws, bs)
    check_grads("fused_mlp_bwd (Burgers)", flat(got), flat(plain),
                flat(fused_mlp_bwd_plain(x.double(), g.double(), f64(Ws),
                                         f64(bs))), {})
    check_k1_repeat("(Burgers)", x, g, Ws, bs, got)
    # where two correct fp32 evaluations can part: the pre-activations
    # nearest 0 (fp64), and the row of dx farthest from the plain version
    h = x.double()
    for li in range(n - 1):
        z = h @ Ws[li].double() + bs[li].double()
        i = int(z.abs().argmin())
        log(f"[burgers]   layer {li} pre-activations: std "
            f"{float(z.std()):.3e}, nearest 0 {float(z.abs().min()):.3e} at "
            f"row {i // z.shape[1]}, unit {i % z.shape[1]} (fp64)")
        h = torch.relu(z)
    row = int((got[0] - plain[0]).abs().amax(dim=1).argmax())
    log(f"[burgers]   K1 backward: dx farthest from the plain fp32 version "
        f"in row {row}")
    reports = {}
    costs = mlp_costs(BB, dims)
    # kernel launches per call: the forward one per layer; the backward
    # recomputes layers 0..n-2, then one launch per layer for dX and [dW; db]
    for name, kern, plain, per_call in (
            ("fused_mlp_fwd", lambda: fused_mlp_fwd(x, Ws, bs),
             lambda: fused_mlp_plain(x, Ws, bs), {"mlp_fwd_layer": n}),
            ("fused_mlp_bwd", lambda: fused_mlp_bwd(x, g, Ws, bs),
             lambda: fused_mlp_bwd_plain(x, g, Ws, bs),
             {"mlp_fwd_layer": n - 1, "mlp_bwd_layer": n})):
        t = [summary(cuda_times_ms(f))[0] for f in (plain, kern, kern, plain)]
        b_ms, b_by = bound(*costs[name])
        reports[name] = dict(ms=min(t[1], t[2]), plain_ms=min(t[0], t[3]),
                             bound_ms=b_ms, bound_by=b_by)
        us, traced = device_us_per_call(kern, list(per_call),
                                        per_call=list(per_call.values()))
        log(f"[burgers]   {name} at the Burgers stack: kernel {t[1]:.4f} / "
            f"{t[2]:.4f} ms (device {us:.1f} us per call of "
            f"{sum(per_call.values())} launches, {traced} traced over 20 "
            f"calls), plain {t[0]:.4f} / {t[3]:.4f} ms; bound "
            f"{b_ms:.5f} ms ({b_by}: {costs[name][0] / 1e6:.1f} MFLOP, "
            f"{costs[name][1] / 1e6:.3f} MB)")
    return reports


def burgers_batches(n, seed=0):
    """bench.py's burgers data, a fresh minibatch per iteration: y0 ~ N(0,
    1) and target y0 + 0.05 N(0, 1), (B, nx) each, numpy from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.normal(size=(BB, BNX))
        tgt = y + 0.05 * rng.normal(size=(BB, BNX))
        out.append((y.astype(np.float32), tgt.astype(np.float32)))
    return out


def build_burgers(device, state, fused, eps=1e-8, flags=()):
    """(ode, ex, Adam) of the Burgers IMEX model on bench.py's recipe from
    ``state`` (FusedStackedMLP layout): the kernel path (``use_fused``: the
    fused ARK step kernels K2/K3, or under ``flags`` -pnode_fused_ark_adjoint
    off K1 and K10/K11) or the plain path (nn.Linear, the roll chain)."""
    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.models import BurgersFuncEX, BurgersFuncIM

    pt.clear_options()
    pt.init(["chip_smoke"] + BURGERS_FLAGS + list(flags))
    im = BurgersFuncIM(nx=BNX, use_fused=fused, device=device)
    ex = BurgersFuncEX(nx=BNX, use_fused=fused, device=device)
    ex.load_state_dict(state if fused else to_linear_state(state))
    ode = pt.ODESolver()
    ode.setupTS(torch.zeros(BB, BNX, device=device), pt.TorchFunc(im),
                step_size=BDT, method="imex", imex_form=True,
                implicit_form=True, func2=pt.TorchFunc(ex),
                linear_solver="hpddm", fixed_jacobian=True, batch_size=BB)
    return ode, ex, torch.optim.Adam(ex.parameters(), lr=LR, eps=eps)


def fused_layout(ex, grads=False):
    """The explicit part's parameters (or their gradients) in
    FusedStackedMLP's layout and order: kernel_i (in, out), bias_i."""
    if ex.use_fused:
        return [p.grad if grads else p for p in ex.parameters()]
    out = []
    for lin in ex.net.layers:
        w, b = (lin.weight.grad, lin.bias.grad) if grads else (lin.weight,
                                                               lin.bias)
        out += [w.t(), b]
    return out


def frozen_J(ode, ex, device):
    """The solve's memoized frozen Jacobian block of f_IM."""
    import torch

    stp = ode._stepper.prepare(0.0, torch.zeros(BB, BNX, device=device),
                               ({}, dict(ex.named_parameters())), dt0=BDT)
    return stp.setup.frozen_J_blocks


@functools.lru_cache(maxsize=2)
def burgers_operators(device):
    """bench.py's Burgers recipe as the port's stepper hands it to the fused
    kernels (``_fused_reverse_args``): the frozen J of BurgersFuncIM, ARK3's
    stage inverse at BDT, the tableau, and the seed-0 BurgersFuncEX stack
    (phase 7's state0) as (Ws, bs); f_EX = +MLP."""
    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.models import BurgersFuncEX, BurgersFuncIM

    pt.clear_options()
    pt.init(["chip_smoke"] + BURGERS_FLAGS)
    im = BurgersFuncIM(nx=BNX, use_fused=True, device=device)
    ex = BurgersFuncEX(nx=BNX, use_fused=True, device=device,
                       generator=torch.Generator(device=device).manual_seed(0))
    ode = pt.ODESolver()
    y = torch.zeros(BB, BNX, device=device)
    ode.setupTS(y, pt.TorchFunc(im), step_size=BDT, method="imex",
                imex_form=True, implicit_form=True, func2=pt.TorchFunc(ex),
                linear_solver="hpddm", fixed_jacobian=True, batch_size=BB)
    params = ({}, dict(ex.named_parameters()))
    stp = ode._stepper.prepare(0.0, y, params, dt0=BDT)
    spec, J, inv = stp._fused_reverse_args(params)
    if spec["sign"] != 1.0:
        raise AssertionError("Burgers' f_EX is +MLP")
    return (J, inv, stp._tableau_static(),
            [w.detach().clone() for w in spec["Ws"]],
            [b.detach().clone() for b in spec["bs"]])


def burgers_partials(name, grid, total):
    """A log line of a Burgers kernel's dW/db partials: grid slices of
    ``total`` floats, written by the blocks and read back by the sum."""
    return (f"{name}: partials {grid} x {total} floats = "
            f"{4 * grid * total / 1e6:.1f} MB written and read back")


def peak_bytes(fn):
    """The device memory one call of ``fn`` allocates at its peak, above
    what was allocated before it (max_memory_allocated)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def adj_at_grid(grid):
    """fused_ark_step_adj in its plan's grid form on ``grid`` co-resident
    blocks: the wrapper's own launch (run_ark_adj) at the grid it takes for
    kernel comparisons. Outputs' bits do not depend on the grid."""
    from pnode_tpu_torch.ops import _build
    from pnode_tpu_torch.ops.fused_ark_adjoint import run_ark_adj

    def fn(tab, dt, Ys, lam, J, inv, Ws, bs, activation="relu", sign=-1.0):
        return run_ark_adj(_build.library(), card_sms(),
                           _build.stream_of(lam), tab, dt, Ys, lam, J, inv,
                           Ws, bs, activation, sign, 0, grid)

    return fn


def loop_at_grid(grid):
    """fused_train_loop (one launch) in its plan's grid form on ``grid``
    co-resident blocks, through run_train_loop as adj_at_grid runs K3."""
    from pnode_tpu_torch.ops import _build
    from pnode_tpu_torch.ops.fused_train_loop import run_train_loop

    def fn(tab, dt, y, tgt, J, inv, Ws, bs, m, v, t0, activation="relu",
           sign=-1.0, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        return run_train_loop(_build.library(), card_sms(),
                              _build.stream_of(y), tab, dt, y, tgt, J, inv,
                              Ws, bs, m, v, t0, activation, sign, lr, b1, b2,
                              eps, len(y), 0, grid)

    return fn


def fwd_at(rows=0, grid=0, form="plan"):
    """fused_ark_step_fwd (with err, given b_err) through its launch
    (run_ark_fwd) at a form the plan does not take, for kernel comparisons:
    the row form at ``rows``, the grid form on ``grid`` co-resident blocks,
    or (``form`` "grid") the grid form where the plan takes the row form.
    Outputs' bits do not depend on the grid."""
    from pnode_tpu_torch.ops import _build
    from pnode_tpu_torch.ops.fused_ark_forward import run_ark_fwd

    def fn(tab, b_err, dt, y, J, inv, Ws, bs, activation="relu", sign=-1.0):
        return run_ark_fwd(_build.library(), card_sms(), _build.stream_of(y),
                           tab, b_err, dt, y, J, inv, Ws, bs, activation,
                           sign, rows, grid, form)

    return fn


def grad_at(rows=0, grid=0, form="plan"):
    """fused_grad_step through its launch (run_grad_step) at a form the
    plan does not take, as fwd_at runs K2."""
    from pnode_tpu_torch.ops import _build
    from pnode_tpu_torch.ops.fused_train_loop import run_grad_step

    def fn(layout, tab, dt, y, tgt, J, inv, params, activation="relu",
           sign=-1.0, global_count=None):
        return run_grad_step(_build.library(), card_sms(),
                             _build.stream_of(y), layout, tab, dt, y, tgt, J,
                             inv, params, activation, sign, global_count,
                             rows, grid, form)

    return fn


def bitwise(a, b):
    """Every tensor of ``a`` equal to its partner in ``b``, bit for bit."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def time_in_turns(fns, reps=20, inner=10):
    """Median ms per call of each of ``fns`` (label -> fn), in the order
    given and then reversed (plain, kernel, kernel, plain): the smaller of
    each one's two medians, each over ``reps`` samples of ``inner``
    back-to-back calls."""
    order = list(fns) + list(fns)[::-1]
    got = {}
    for k in order:
        t = summary(cuda_times_ms(fns[k], reps=reps, warmup=2,
                                  inner=inner))[0]
        got[k] = min(got.get(k, t), t)
    return got


def phase_burgers_kernels(device):
    """Phase 3 at Burgers-512, bench.py's recipe (B 200, 512 -> 576 x4 ->
    512, ARK3, dt 1e-3, BurgersFuncIM's J and stage inverse, the seed-0
    BurgersFuncEX stack, f_EX = +MLP; y ~ N(0, 1), target y + 0.05 N(0, 1)).
    K2 (without and with err) and K3 on those inputs against their plain
    versions in fp32 and fp64 with phase 3's gates, each in its plan's grid
    form (at the plan's grid and at half of it) and in the row form at
    forced R (K2's 2, K3's 1: the forms their plans took before the grid
    form); K2's y1, stage values and err bitwise equal across two calls,
    the two grids and the row form; K3's lam_prev, dW and db bitwise
    across two calls and the two grids, lam_prev bitwise equal to the row
    form's; each timed in turns with its plain version and the row form
    and by the profiler; K12 at (200, 512) and at the two-rank shard (100,
    512) (check_grad_step, then grad_grid_checks: its grid form bitwise
    across calls, grids and the K2 -> seed -> K3 chain, timed beside its
    plain version and the row form at R 1); K4 over K = 8
    distinct minibatches against fused_train_loop_plain (check_loop, K4's
    gates) in the grid form and in the row form at forced R 1, the grid
    form's two calls and two grids bitwise equal, per iteration in turns
    with its plain version and the row form and by the profiler; each
    one's device memory per call in both forms. Returns the JSON line's
    ``burgers`` entries of K2, K3, K4 and K12 (bounds from ark_costs at
    these shapes)."""
    import torch

    from pnode_tpu_torch.ops.fused_ark_adjoint import (
        GRID_FWD, GRID_LOOP, GRID_STEP, ark_adj_plan, ark_fwd_plan,
        fused_ark_step_adj, fused_ark_step_adj_plain, grid_plan)
    from pnode_tpu_torch.ops.fused_ark_forward import (
        fused_ark_step_fwd, fused_ark_step_fwd_embedded,
        fused_ark_step_fwd_plain)
    from pnode_tpu_torch.ops.fused_mlp import grad_buffer_size
    from pnode_tpu_torch.ops.fused_train_loop import (
        fused_train_loop, fused_train_loop_plain, train_loop_plan)
    from pnode_tpu_torch.tableaus import get_ark_tableau

    J, inv, tab, Ws, bs = burgers_operators(device)
    dt = float(np.float32(BDT))
    s, dims, K = len(tab[2]), [BNX] + BURGERS_LAYERS, DP_K
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device=device)
    f64 = lambda ts: [t.double() for t in ts]  # noqa: E731
    pairs = burgers_batches(K + 1, seed=5)
    ys, tgts = (f32(np.stack([p[i] for p in pairs[:K]])) for i in (0, 1))
    y, tgt = f32(pairs[K][0]), f32(pairs[K][1])
    lam = f32(np.random.default_rng(6).normal(size=(BB, BNX)))
    total = grad_buffer_size(dims)
    costs = ark_costs(tab, BB, dims, K)
    reports = {}
    log(f"[kernels] Burgers-512 (B {BB}, {dims}, ARK3, dt {BDT}): K2, K3, "
        f"K12 and K4 on bench.py's recipe")

    # K2, without and with err: the plan's grid form, at its grid and at
    # half of it, and the row form at forced R 2
    args = (tab, dt, y, J, inv, Ws, bs, "relu", 1.0)
    args64 = (tab, dt, y.double(), J.double(), inv.double(), f64(Ws),
              f64(bs), "relu", 1.0)
    t3 = get_ark_tableau("3")
    berr = ([float(x) for x in t3.b_im_err], [float(x) for x in t3.b_ex_err])
    fplan = ark_fwd_plan(BB, BNX, BURGERS_LAYERS, s, card_sms())
    if fplan[0] != 0:
        raise AssertionError(f"K2's plan at Burgers-512 is not the grid "
                             f"form: {fplan}")
    ws = 4 * grid_plan(GRID_FWD, BB, BNX, BURGERS_LAYERS, s, card_sms())[2]
    plain = fused_ark_step_fwd_plain(*args)
    ref = fused_ark_step_fwd_plain(*args64)
    plain_e = fused_ark_step_fwd_plain(*args, b_err=berr)
    ref_e = fused_ark_step_fwd_plain(*args64, b_err=berr)
    etol = max(1e-4, 3.0 * rel_err(plain_e[1], ref_e[1]))  # phase_k2_edges'
    rep, outs = {}, {}
    forms = {"grid": (fused_ark_step_fwd, fused_ark_step_fwd_embedded),
             "half grid": (fwd_at(grid=fplan[1] // 2),) * 2,
             "row R 2": (fwd_at(rows=2),) * 2}
    for label, (fn, fn_e) in forms.items():
        if label == "grid":
            got, gote = fn(*args), fn_e(tab, berr, *args[1:])
        else:
            got, gote = fn(tab, None, *args[1:]), fn(tab, berr, *args[1:])
        torch.cuda.synchronize()
        check_kernel(f"fused_ark_step_fwd (Burgers) {label}", list(got),
                     list(plain), list(ref), 1e-5,
                     rep if label == "grid" else {})
        check_kernel(f"fused_ark_step_fwd_embedded (Burgers) {label} (y1, "
                     f"Ys)", [gote[0], gote[2]], [plain_e[0], plain_e[2]],
                     [ref_e[0], ref_e[2]], 1e-5, {})
        check_kernel(f"fused_ark_step_fwd_embedded (Burgers) {label} (err)",
                     [gote[1]], [plain_e[1]], [ref_e[1]], etol, {},
                     tol64=etol)
        outs[label] = list(got) + list(gote)
    again = list(fused_ark_step_fwd(*args)) + list(
        fused_ark_step_fwd_embedded(tab, berr, *args[1:]))
    torch.cuda.synchronize()
    bits = (bitwise(outs["grid"], again),
            bitwise(outs["grid"], outs["half grid"]),
            bitwise(outs["grid"], outs["row R 2"]))
    log(f"[kernels]   fused_ark_step_fwd (Burgers): y1, Ys and err bitwise "
        f"across two calls {bits[0]}, across grids {fplan[1]} and "
        f"{fplan[1] // 2} {bits[1]}, equal to the row form's at R 2 "
        f"{bits[2]}")
    if not all(bits):
        raise AssertionError("K2's grid form at Burgers-512 is not bitwise "
                             "stable, or not the row form's")
    row2 = fwd_at(rows=2)
    k2 = {}
    for key, b_err, kern in (
            ("", None, lambda: fused_ark_step_fwd(*args)),
            ("err", berr,
             lambda: fused_ark_step_fwd_embedded(tab, berr, *args[1:]))):
        row = lambda e=b_err: row2(tab, e, *args[1:])  # noqa: E731
        t = time_in_turns({
            "plain": lambda e=b_err: fused_ark_step_fwd_plain(*args,
                                                              b_err=e),
            "kernel": kern, "row R 2": row}, reps=10)
        dev, traced = device_us_per_call(kern, ["ark_fwd_grid_kernel"])
        dev_row = device_us_per_call(row, ["ark_fwd_kernel"])[0]
        peak, peak_row = peak_bytes(kern), peak_bytes(row)
        k2[key] = dict(ms=t["kernel"], plain_ms=t["plain"],
                       device_ms=dev / 1e3, peak_bytes=peak,
                       row_r2_ms=t["row R 2"], row_r2_device_ms=dev_row / 1e3,
                       row_r2_peak_bytes=peak_row)
        log(f"[kernels]   fused_ark_step_fwd (Burgers{', err' if key else ''}"
            f"): plan {fplan} (rows 0: the grid form), workspace {ws} B; "
            f"kernel {t['kernel']:.4f} ms (device {dev / 1e3:.4f} ms, "
            f"{traced} traced), plain {t['plain']:.4f} ms; the row form at R "
            f"2 {t['row R 2']:.4f} ms (device {dev_row / 1e3:.4f} ms), in "
            f"turns; device memory a call allocates: grid form "
            f"{peak / 1e6:.1f} MB, row form {peak_row / 1e6:.1f} MB")
    reports["fused_ark_step_fwd"] = dict(
        rep, **k2[""], form="grid", grid=fplan[1], smem_bytes=fplan[2],
        workspace_bytes=ws, err=k2["err"])

    # K3 on the plain forward's stage values: the plan's grid form, at its
    # grid and at half of it, and the row form at forced R 1
    Ys = plain[1]
    aargs = (tab, dt, Ys, lam, J, inv, Ws, bs, "relu", 1.0)
    flat3 = lambda r: [r[0], *r[1][0], *r[1][1]]  # noqa: E731
    n, worst = relu_flips(Ys, Ws, bs)
    log(f"[kernels]   fused_ark_step_adj (Burgers): {n} ReLU decisions part "
        f"between the kernel's and the plain version's products (largest "
        f"fp64 |z| {worst:.3e})")
    plan = ark_adj_plan(BB, BNX, BURGERS_LAYERS, s, card_sms())
    ws = 4 * grid_plan(GRID_STEP, BB, BNX, BURGERS_LAYERS, s,
                       card_sms())[2]
    if plan[0] != 0:
        raise AssertionError(f"K3's plan at Burgers-512 is not the grid "
                             f"form: {plan}")
    rep = {}
    plain3 = flat3(fused_ark_step_adj_plain(*aargs))
    ref3 = flat3(fused_ark_step_adj_plain(
        tab, dt, Ys.double(), lam.double(), J.double(), inv.double(),
        f64(Ws), f64(bs), "relu", 1.0))
    outs = {}
    for label, fn in (
            ("grid", fused_ark_step_adj), ("half grid", adj_at_grid(
                plan[1] // 2)),
            ("row R 1", functools.partial(fused_ark_step_adj, rows=1))):
        outs[label] = flat3(fn(*aargs))
        check_kernel(f"fused_ark_step_adj (Burgers) {label}", outs[label],
                     plain3, ref3, 1e-4, rep if label == "grid" else {})
    again = flat3(fused_ark_step_adj(*aargs))
    torch.cuda.synchronize()
    bits = (bitwise(outs["grid"], again),
            bitwise(outs["grid"], outs["half grid"]),
            torch.equal(outs["grid"][0], outs["row R 1"][0]))
    log(f"[kernels]   fused_ark_step_adj (Burgers): lam_prev, dW and db "
        f"bitwise across two calls {bits[0]}, across grids {plan[1]} and "
        f"{plan[1] // 2} {bits[1]}; lam_prev bitwise equal to the row "
        f"form's {bits[2]}")
    if not all(bits):
        raise AssertionError("K3's grid form at Burgers-512 is not bitwise "
                             "stable")
    t = time_in_turns({
        "plain": lambda: fused_ark_step_adj_plain(*aargs),
        "kernel": lambda: fused_ark_step_adj(*aargs),
        "row R 1": lambda: fused_ark_step_adj(*aargs, rows=1)},
        reps=5, inner=4)
    dev = device_us_per_call(lambda: fused_ark_step_adj(*aargs),
                             ["ark_adj_grid_kernel"], n=5)[0]
    dev_row = device_us_per_call(
        lambda: fused_ark_step_adj(*aargs, rows=1),
        ["ark_adj_kernel", "sum_partials_kernel"], n=5)[0]
    peak = peak_bytes(lambda: fused_ark_step_adj(*aargs))
    peak_row = peak_bytes(lambda: fused_ark_step_adj(*aargs, rows=1))
    bms = bound(*costs["fused_ark_step_adj"])[0]
    reports["fused_ark_step_adj"] = dict(
        rep, ms=t["kernel"], plain_ms=t["plain"], device_ms=dev / 1e3,
        form="grid", grid=plan[1], smem_bytes=plan[2], workspace_bytes=ws,
        peak_bytes=peak, row_r1_ms=t["row R 1"],
        row_r1_device_ms=dev_row / 1e3, row_r1_peak_bytes=peak_row)
    log(f"[kernels]   fused_ark_step_adj (Burgers): plan {plan} (rows 0: "
        f"the grid form; grid, shared-memory bytes), workspace {ws} B; "
        f"kernel {t['kernel']:.4f} ms (device {dev / 1e3:.4f} ms), plain "
        f"{t['plain']:.4f} ms, bound {bms:.5f} ms; the row form at R 1 "
        f"{t['row R 1']:.4f} ms (device {dev_row / 1e3:.4f} ms), in turns; "
        f"device memory a call allocates: grid form {peak / 1e6:.1f} MB, "
        f"row form {peak_row / 1e6:.1f} MB ("
        + burgers_partials("the row form's", BB, total) + ")")

    # K12 at the whole batch and the two-rank shard: against the plain
    # versions in the plan's grid form and at every forced R, then the grid
    # form's bits and times
    rep, k12 = {}, {}
    for B in (BB, BB // 2):
        gargs = check_grad_step(f"Burgers B {B}", tab, dt, J, inv, Ws, bs,
                                y[:B], tgt[:B], rep if B == BB else {},
                                sign=1.0)
        k12[B] = grad_grid_checks(f"Burgers B {B}", gargs, Ws, bs)
    reports["fused_grad_step"] = dict(rep, **k12[BB], shard=k12[BB // 2])

    # K4 over K distinct minibatches: the grid form and the row form at R 1,
    # each against the plain version
    run = loop_runner(tab, dt, J, inv, Ws, bs, ys, tgts, sign=1.0)
    lplan = train_loop_plan(BB, BNX, BURGERS_LAYERS, s, sms=card_sms())
    ws = 4 * grid_plan(GRID_LOOP, BB, BNX, BURGERS_LAYERS, s,
                       card_sms())[2]
    rplan = train_loop_plan(BB, BNX, BURGERS_LAYERS, s, sms=card_sms(),
                            rows=1)
    if lplan[0] != 0:
        raise AssertionError(f"K4's plan at Burgers-512 is not the grid "
                             f"form: {lplan}")
    log(f"[kernels]   fused_train_loop (Burgers): plan (rows, grid, smem) "
        f"{lplan} (rows 0: the grid form), workspace {ws} B; the row form "
        f"at R 1: {rplan}, {-(-BB // rplan[0]) - rplan[1]} blocks take a "
        f"second row tile; "
        + burgers_partials("the row form's", rplan[1], -(-total // 4) * 4))
    rep = {}
    check_loop(f"Burgers B{BB} grid form", run, K, None, rep, stepwise=True)
    check_loop(f"Burgers B{BB} row form R 1", run, K, None, {}, rows=1,
               stepwise=True)
    flat = lambda o: o[0] + o[1] + list(o[2][0]) + list(o[2][1]) \
        + list(o[3][0]) + list(o[3][1]) + [o[4]]  # noqa: E731
    one = run(fused_train_loop, K, 1e-8)
    again = run(fused_train_loop, K, 1e-8)
    half = run(loop_at_grid(lplan[1] // 2), K, 1e-8)
    torch.cuda.synchronize()
    bits = (bitwise(flat(one), flat(again)), bitwise(flat(one), flat(half)))
    log(f"[kernels]   fused_train_loop (Burgers): parameters, moments and "
        f"losses bitwise across two calls {bits[0]}, across grids "
        f"{lplan[1]} and {lplan[1] // 2} {bits[1]}")
    if not all(bits):
        raise AssertionError("fused_train_loop (Burgers): the grid form is "
                             "not bitwise stable")
    kern = lambda: run(fused_train_loop, K, 1e-8)  # noqa: E731
    row = lambda: run(fused_train_loop, K, 1e-8, rows=1)  # noqa: E731
    t = time_in_turns({"plain": lambda: run(fused_train_loop_plain, K, 1e-8),
                       "kernel": kern, "row R 1": row}, reps=5, inner=2)
    dev_ms, traced = loop_device_ms(kern, "train_loop_grid_kernel", K)
    dev_row, _ = loop_device_ms(row, "train_loop_kernel", K)
    peak, peak_row = peak_bytes(kern), peak_bytes(row)
    bms = bound(*costs["fused_train_loop"])[0]
    reports["fused_train_loop"] = dict(
        rep, ms=t["kernel"] / K, plain_ms=t["plain"] / K, device_ms=dev_ms,
        form="grid", grid=lplan[1], smem_bytes=lplan[2], workspace_bytes=ws,
        peak_bytes=peak, row_r1_ms=t["row R 1"] / K,
        row_r1_device_ms=dev_row, row_r1_peak_bytes=peak_row)
    log(f"[kernels]   fused_train_loop (Burgers): per iteration kernel "
        f"{t['kernel'] / K:.4f} ms (device {dev_ms:.4f} ms, {traced} "
        f"launches traced), plain {t['plain'] / K:.4f} ms, bound {bms:.5f} "
        f"ms; the row form at R 1 {t['row R 1'] / K:.4f} ms (device "
        f"{dev_row:.4f} ms), in turns, K {K}; device memory a call of K {K} "
        f"allocates: grid form {peak / 1e6:.1f} MB, row form "
        f"{peak_row / 1e6:.1f} MB")
    for name, r in reports.items():
        r["bound_ms"], r["bound_by"] = bound(*costs[name])
    return reports


def burgers_runs_agree(label, eps, got, ref, tol=5e-4, tol_flip=5e-3,
                       params=True):
    """Phase 7(b)'s form for two free-running Burgers runs (losses, params
    in FusedStackedMLP's layout): the losses within ``tol`` relative, the
    params within ``tol_flip`` norm-wise over the whole stack at either
    Adam eps (printed only, without ``params``). A ReLU flip between two
    correct fp32 evaluations moves a gradient ~1e-3 norm-wise, and the
    weight gradients, which dt 1e-3 scales, lie near eps 1e-8, where Adam
    passes a gradient's rounding on amplified by up to lr/eps (per tensor
    and in max abs the figures are printed). Logs, returns ok."""
    import torch

    (lk, pk), (lg, pg) = got, ref
    lk, lg = lk.double().cpu(), lg.double().cpu()
    lrel = float(((lk - lg).abs() / lg.abs()).max())
    flat = lambda ps: torch.cat([p.detach().double().cpu().reshape(-1)  # noqa
                                 for p in ps])
    pnorm = norm_err(flat(pk), flat(pg))
    log(f"[burgers]     free-running vs {label}, Adam eps {eps:.0e}: losses "
        f"max rel err {lrel:.3e} (tol {tol:.0e}); params norm-wise over the "
        f"stack {pnorm:.3e} (tol {tol_flip:.0e}), per tensor max "
        f"{norm_rel(pk, pg):.3e}, max abs diff "
        f"{max(abs_err(a, b) for a, b in zip(pk, pg)):.3e}"
        + ("" if params else "; params not gated"))
    return lrel <= tol and (pnorm <= tol_flip or not params)


def phase_burgers_paths_agree(device, state0, batches, tol=5e-4,
                              tol_flip=5e-3, flags=()):
    """Phase 7(b), in phase 4(a)'s form: the kernel path (K2/K3, or under
    ``flags`` -pnode_fused_ark_adjoint off K1 and K10/K11) against the plain
    path from the same weights and batches. Per Adam step, both evaluate the
    loss (within ``tol`` relative) and the gradients (norm-wise per tensor,
    within ``tol_flip``) from the kernel path's parameters; run free at
    Adam eps 1e-8 and 1e-6, the losses within ``tol`` and the final
    parameters within ``tol_flip`` norm-wise over the whole stack (on the
    K2/K3 route at eps 1e-6 only, printed at 1e-8: a ReLU flip between
    K3's recompute and cuBLAS at a step, then Adam at eps 1e-8 on
    gradients near eps, parted the stack by 4.8e-3 in 4 steps on an H100,
    PERF.md). The
    gradient and parameter gates take a ReLU flip between two correct fp32
    evaluations (phase_burgers_mlp: ~1.5e-3 norm-wise on the gradients;
    Adam then steps a flipped unit's parameters up to lr apart); a wrong
    stencil or stack moves the losses by far more than ``tol``. The frozen
    J assembled through K10 must equal the roll chain's bitwise. Returns
    the kernel path's free-running runs, {eps: (losses, params)}."""
    import torch

    # the plain path first: each build resets the options, and the kernel
    # path reads its route flag at every step
    ode_p, ex_p, _ = build_burgers(device, state0, False)
    ode_k, ex_k, opt_k = build_burgers(device, state0, True, flags=flags)
    step_l = step_g = 0.0
    losses = []
    for y0, tgt in batches:
        ex_p.load_state_dict(to_linear_state(
            {k: v.detach() for k, v in ex_k.state_dict().items()}))
        l_p, _ = loss_and_grads(ode_p, ex_p, y0, tgt, device, BDT)
        l_k, _ = loss_and_grads(ode_k, ex_k, y0, tgt, device, BDT)
        g_p, g_k = fused_layout(ex_p, True), fused_layout(ex_k, True)
        step_l = max(step_l, abs(l_k - l_p) / abs(l_p))
        step_g = max(step_g, max(float((a - b).norm() / b.norm())
                                 for a, b in zip(g_k, g_p)))
        opt_k.step()
        losses.append(l_k)
    J_k, J_p = frozen_J(ode_k, ex_k, device), frozen_J(ode_p, ex_p, device)
    same_J = bool(torch.equal(J_k, J_p))
    log(f"[burgers] (b) {len(batches)} Adam steps, kernel path "
        f"{' '.join(flags) or '(K2/K3)'} vs plain path "
        f"from the same parameters: max rel err loss {step_l:.3e} (tol "
        f"{tol:.0e}), gradients {step_g:.3e} (norm-wise; tol "
        f"{tol_flip:.0e}); frozen J through K10 "
        f"{'equals' if same_J else 'DIFFERS FROM'} the roll chain's "
        f"(max |J| {float(J_k.abs().max()):.3e})")
    kernel_runs = {1e-8: (torch.tensor(losses), fused_layout(ex_k))}
    ode, ex, opt = build_burgers(device, state0, True, eps=1e-6, flags=flags)
    kernel_runs[1e-6] = (train(ode, ex, opt, batches, device, BDT),
                         fused_layout(ex))
    ok = step_l <= tol and step_g <= tol_flip and same_J
    for eps, (lk, pk) in kernel_runs.items():
        ode, ex, opt = build_burgers(device, state0, False, eps=eps)
        lg, pg = train(ode, ex, opt, batches, device, BDT), fused_layout(ex)
        ok = burgers_runs_agree("the plain path", eps, (lk, pk), (lg, pg),
                                tol, tol_flip,
                                params=eps != 1e-8 or bool(flags)) and ok
    if not ok:
        raise AssertionError("the Burgers kernel and plain paths disagree")
    return kernel_runs


def phase_burgers_trainer(device):
    """Phase 7(c): examples/burgers_torch.py through its main() with
    bench.py's numerics (nx 512, batch 200, dt 1e-3, --use_fused,
    --linear_solver hpddm --fixed_jacobian: its defaults until slice 4(b)),
    --batch_time 2, 3 iterations of one epoch and 20 ICs of data (the
    default 100 take ~18 s of numpy generation on the card's host)."""
    import pnode_tpu_torch as pt

    mod = load_example("burgers_torch")
    pt.clear_options()
    t0 = time.perf_counter()
    final = mod.main(["--batch_time", "2", "--epochs", "1",
                      "--iters_per_epoch", "3", "--n_ic", "20",
                      "--linear_solver", "hpddm", "--fixed_jacobian",
                      "--device", device,
                      "--train_dir", os.path.join(ROOT, "build",
                                                  "burgers_torch")])
    log(f"[burgers] (c) examples/burgers_torch.py --batch_time 2 "
        f"--iters_per_epoch 3 --n_ic 20: final train loss {final:.6e} in "
        f"{time.perf_counter() - t0:.1f} s (data generation included)")
    if not np.isfinite(final):
        raise AssertionError("burgers_torch.py gave a non-finite loss")


def train_timed(ode, ex, opt, batches, warm, device):
    """Adam iterations over ``batches``: the losses, and steps/s over those
    after the first ``warm``."""
    import torch

    l_warm = train(ode, ex, opt, batches[:warm], device, BDT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_rest = train(ode, ex, opt, batches[warm:], device, BDT)
    torch.cuda.synchronize()
    sps = (len(batches) - warm) / (time.perf_counter() - t0)
    return torch.cat([l_warm, l_rest]).cpu().numpy(), sps


def phase_burgers_loop(device, state0, kernel_runs, per_step, n_iters=320,
                       warm=20):
    """Phase 7(d): bench.py's Burgers training loop on the port, K4 on the
    operands of the stepper's fused gate (ks_torch's FusedLoop, the state
    of ``--fused_loop``), from state0. Its first 4 iterations against
    (b)'s per-step K2/K3 path in phase 7(b)'s form (burgers_runs_agree)
    on (b)'s batches, the parameters at Adam eps 1e-8 printed only: K4's
    fp32 bias correction against torch.optim.Adam's double one alone parts
    them by ~2e-3 of the stack in 4 steps there (the plain versions on the
    CPU); one traced launch of 20 iterations (the device's busy share,
    K4's device time); then bench.py's protocol on fresh minibatches, one
    per iteration (y ~ N(0, 1), target y + 0.05 N(0, 1), made in bulk): a
    warm launch of ``warm`` iterations and a timed launch of the rest:
    finite losses, the mean of the last 20 below the first 20, steps/s
    beside ``per_step`` ({path: steps/s} of (b), same call). Returns K4's
    launches over the phase."""
    import torch

    from pnode_tpu_torch.ops.fused_train_loop import fused_train_loop

    ks = load_example("ks_torch")
    fused_train_loop.launches = 0

    def fresh_loop():
        ode, ex, _ = build_burgers(device, state0, True)
        return ex, ks.FusedLoop(ode, ex, BB, BDT)

    as_t = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=device)
    first = burgers_batches(4)
    ok = True
    for eps, ref in kernel_runs.items():
        ex, loop = fresh_loop()
        losses = loop.run(as_t(np.stack([b[0] for b in first])),
                          as_t(np.stack([b[1] for b in first])), LR, eps=eps)
        loop.copy_to(ex)
        ok = burgers_runs_agree("(b)'s per-step K2/K3 path", eps,
                                (losses, fused_layout(ex)), ref,
                                params=eps != 1e-8) and ok
    if not ok:
        raise AssertionError("the Burgers fused loop and per-step kernel "
                             "path disagree")
    rng = np.random.default_rng(21)
    y = rng.normal(size=(n_iters, BB, BNX)).astype(np.float32)
    ys = as_t(y)
    tgts = as_t(y + np.float32(0.05) * rng.normal(
        size=y.shape).astype(np.float32))
    profile_loop(lambda: fresh_loop()[1], ys[:warm], tgts[:warm],
                 kernel="train_loop_grid_kernel")
    ex, loop = fresh_loop()
    peak = peak_bytes(lambda: loop.run(ys[:warm], tgts[:warm], LR))
    log(f"[burgers] (d) device memory a launch of {warm} iterations on K4 "
        f"allocates at its peak: {peak / 1e6:.1f} MB")
    ex, loop = fresh_loop()
    loss_warm = loop.run(ys[:warm], tgts[:warm], LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_rest = loop.run(ys[warm:], tgts[warm:], LR)
    torch.cuda.synchronize()
    sps = (n_iters - warm) / (time.perf_counter() - t0)
    losses = torch.cat([loss_warm, loss_rest]).cpu().numpy()
    count = fused_train_loop.launches
    lo, hi = float(losses[:20].mean()), float(losses[-20:].mean())
    log(f"[burgers] (d) bench.py's Burgers loop on K4: {n_iters} Adam "
        f"iterations on fresh minibatches, mean loss first 20 {lo:.6e}, last "
        f"20 {hi:.6e}; {sps:.2f} steps/s (a launch of {n_iters - warm} after "
        f"one of {warm}) beside the per-step paths' "
        + ", ".join(f"{k} {v:.2f}" for k, v in per_step.items())
        + f" steps/s, same call; {count} launches")
    if not (np.all(np.isfinite(losses)) and hi < lo):
        raise AssertionError("bench.py's Burgers loop on K4 did not reduce "
                             "the loss")
    if count <= 0:
        raise AssertionError("fused_train_loop was never launched on the "
                             "Burgers loop")
    return count


def phase_burgers(device, n_steps=50, warm=5, n_off=20, n_plain=20):
    """Phase 7: the Burgers slice. Returns K10's and K11's reports, the
    launch counts of K2, K3, K4, K10 and K11 over (b) and (d), and K1's
    readings at the Burgers stack with its launches over (b)'s off path."""
    import torch

    from pnode_tpu_torch.models import BurgersFuncEX
    from pnode_tpu_torch.ops.circular_stencil import (
        circular_stencil_bwd, circular_stencil_fwd)
    from pnode_tpu_torch.ops.fused_ark_adjoint import (
        ark_adj_plan, ark_fwd_plan, fused_ark_fits, fused_ark_step_adj)
    from pnode_tpu_torch.ops.fused_ark_forward import fused_ark_step_fwd
    from pnode_tpu_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_fwd

    reports = phase_stencil_kernels(device)
    init = BurgersFuncEX(nx=BNX, use_fused=True, device=device,
                         generator=torch.Generator(device=device).manual_seed(0))
    state0 = {k: v.detach().clone() for k, v in init.state_dict().items()}
    k1_reports = phase_burgers_mlp(device, state0)

    layers = BURGERS_LAYERS
    log(f"[burgers] (b) bench.py's burgers recipe: B {BB}, nx {BNX}, dt "
        f"{BDT}, ARK3, hpddm + frozen J, {' '.join(BURGERS_FLAGS)}, one-step "
        f"MSE, Adam lr {LR}, seed-0 weights; the fused ARK step kernels "
        f"take it: fused_ark_fits {fused_ark_fits(BNX, layers, 4)} (K2: plan "
        f"{ark_fwd_plan(BB, BNX, layers, 4)} (rows, grid, B); K3: plan "
        f"{ark_adj_plan(BB, BNX, layers, 4)}, the grid form)")
    batches = burgers_batches(n_steps)
    wrappers = {"fused_mlp_fwd": fused_mlp_fwd, "fused_mlp_bwd": fused_mlp_bwd,
                "circular_stencil_fwd": circular_stencil_fwd,
                "circular_stencil_bwd": circular_stencil_bwd,
                "fused_ark_step_fwd": fused_ark_step_fwd,
                "fused_ark_step_adj": fused_ark_step_adj}
    off = ["-pnode_fused_ark_adjoint", "off"]
    counts, sps, runs = {}, {}, {}
    for route, flags, n in (("K2/K3", (), n_steps),
                            ("off (K1, K10/K11)", off, n_off)):
        for w in wrappers.values():
            w.launches = 0
        runs[route] = phase_burgers_paths_agree(device, state0, batches[:4],
                                                flags=flags)
        ode, ex, opt = build_burgers(device, state0, True, flags=flags)
        losses, sps[route] = train_timed(ode, ex, opt, batches[:n], warm,
                                         device)
        counts[route] = {k: w.launches for k, w in wrappers.items()}
        peak = peak_bytes(lambda: train(ode, ex, opt, batches[:1], device,
                                        BDT))
        log(f"[burgers] (b) {route}: device memory one more Adam step "
            f"allocates at its peak: {peak / 1e6:.1f} MB")
        lo, hi = float(losses[:10].mean()), float(losses[-10:].mean())
        log(f"[burgers] (b) {n} Adam steps on the kernel path {route}: mean "
            f"loss first 10 {lo:.6e}, last 10 {hi:.6e}; {sps[route]:.2f} "
            f"steps/s (steps {warm}..{n})")
        log(f"[burgers] launches over (b)'s agreement and training on "
            f"{route} ({8 + n} kernel-path iterations): {counts[route]}")
        if not (np.all(np.isfinite(losses)) and hi < lo):
            raise AssertionError(f"Burgers training on {route} did not "
                                 "reduce the loss")
        profile_steps(f"Burgers kernel path {route}", ode, ex, opt,
                      batches[:1], device, BDT,
                      focus=("ark_", "K2/K3") if not flags else ("mlp_",
                                                                 "K1"))
    ode_p, ex_p, opt_p = build_burgers(device, state0, False)
    train(ode_p, ex_p, opt_p, batches[:3], device, BDT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train(ode_p, ex_p, opt_p, batches[3:3 + n_plain], device, BDT)
    torch.cuda.synchronize()
    sps["plain"] = n_plain / (time.perf_counter() - t0)
    log(f"[burgers] plain path (nn.Linear, the roll chain): "
        f"{sps['plain']:.2f} steps/s over {n_plain} steps, beside the kernel "
        f"paths' " + ", ".join(f"{k} {v:.2f}" for k, v in sps.items()
                              if k != "plain"))
    profile_steps("Burgers plain path", ode_p, ex_p, opt_p, batches[:1],
                  device, BDT)
    k23, k1 = counts["K2/K3"], counts["off (K1, K10/K11)"]
    for name in ("fused_ark_step_fwd", "fused_ark_step_adj"):
        if k23[name] <= 0:
            raise AssertionError(f"{name} was never launched on the Burgers "
                                 "path")
    for name in ("fused_mlp_fwd", "fused_mlp_bwd", "circular_stencil_fwd",
                 "circular_stencil_bwd"):
        if k1[name] <= 0:
            raise AssertionError(f"{name} was never launched on the Burgers "
                                 "path under -pnode_fused_ark_adjoint off")
    if k1["fused_ark_step_fwd"] or k1["fused_ark_step_adj"]:
        raise AssertionError("the fused ARK step kernels ran under "
                             "-pnode_fused_ark_adjoint off")
    phase_burgers_trainer(device)
    k4 = phase_burgers_loop(device, state0, runs["K2/K3"], sps)
    for name in ("fused_mlp_fwd", "fused_mlp_bwd"):
        k1_reports[name]["launches"] = k1[name]
    launches = {name: k23[name] + k1[name] for name in STENCIL_KERNELS}
    launches.update({name: k23[name] for name in ("fused_ark_step_fwd",
                                                  "fused_ark_step_adj")})
    launches["fused_train_loop"] = k4
    return reports, launches, k1_reports


# -- phase 8: the data-parallel slice -----------------------------------------

DP_K = 8            # iterations held against K4 in (b) and (c)
DP_ITERS = 200      # (d): a warm call of 20, a timed call of 180
DP_SHARDS = (256, 128, 64, 32)  # B_local at world 1, 2, 4 and 8
DP_BURGERS_ITERS = 64  # (f): the DP loop's and K4's iterations/s


def check_grad_step(label, tab, dt, J, inv, Ws, bs, y, tgt, report,
                    sign=-1.0):
    """K12 against fused_grad_step_plain in fp32 and in fp64, phase 3's K3
    gates: loss, dW and db within 1e-4 relative (to max |ref|) of both, at
    the plan's rows per block and at every forced R whose plan fits (the
    loss at each R is printed: each block sums its own rows' squared
    errors, so R regroups the sum). f_EX = sign * MLP."""
    import torch

    from pnode_tpu_torch.ops.fused_ark_adjoint import (forced_rows,
                                                       grad_step_plan)
    from pnode_tpu_torch.ops.fused_train_loop import (
        LoopLayout, fused_grad_step, fused_grad_step_plain)

    layout = LoopLayout(y.shape[0], y.shape[1], [w.shape[1] for w in Ws])
    params = layout.pack(Ws, bs)
    args = (layout, tab, dt, y, tgt, J, inv, params, "relu", sign)
    flat = lambda out: [out[0], *layout.unpack(out[1])[0],  # noqa: E731
                        *layout.unpack(out[1])[1]]
    plain = fused_grad_step_plain(*args)
    ref64 = fused_grad_step_plain(layout, tab, dt, y.double(), tgt.double(),
                                  J.double(), inv.double(), params.double(),
                                  "relu", sign)
    s, dims = len(tab[2]), layout.dims
    forced = forced_rows(dims[0], dims[1:], s, grad=True)
    losses = {}
    for R in [0] + forced:
        got = fused_grad_step(*args, rows=R)
        torch.cuda.synchronize()
        check_kernel(f"fused_grad_step {label} R {R or 'plan'}", flat(got),
                     flat(plain), flat(ref64), 1e-4, report if R == 0 else {})
        losses[R] = float(got[0])
    log(f"[dp]   K12 {label}: plan {grad_step_plan(*y.shape, dims[1:], s)} "
        f"(rows, grid, B); loss by R {losses}")
    return args


def grad_grid_checks(label, args, Ws, bs):
    """K12 in its plan's grid form on ``args`` (check_grad_step's): the
    loss and gradient bitwise across two calls and across the plan's grid
    and half of it; the gradient bitwise equal to the K2 -> seed -> K3
    chain (K2's grid form, the seed 2 (y1 - tgt) / (B d) in fp32 as K12
    forms it, K3's grid form on K2's stage values), the loss printed
    beside it; timed in turns with the plain version and the row form at R
    1, by the profiler, and by the device memory one call allocates in
    both forms. Returns the readings."""
    import torch

    from pnode_tpu_torch.ops.fused_ark_adjoint import (
        GRID_GRAD, fused_ark_step_adj, grad_step_plan, grid_plan)
    from pnode_tpu_torch.ops.fused_ark_forward import fused_ark_step_fwd
    from pnode_tpu_torch.ops.fused_train_loop import (
        fused_grad_step, fused_grad_step_plain)

    layout, tab, dt, y, tgt, J, inv, params, act, sign = args
    (B, d), s = y.shape, len(tab[2])
    plan = grad_step_plan(B, d, layout.dims[1:], s, card_sms())
    if plan[0] != 0:
        raise AssertionError(f"K12's plan {label} is not the grid form: "
                             f"{plan}")
    ws = 4 * grid_plan(GRID_GRAD, B, d, layout.dims[1:], s, card_sms())[2]
    one = fused_grad_step(*args)
    again = fused_grad_step(*args)
    half = grad_at(grid=plan[1] // 2)(*args)
    y1, ys = fused_ark_step_fwd(tab, dt, y, J, inv, Ws, bs, act, sign)
    seed = (y1 - tgt) * torch.tensor(np.float32(2.0 / (B * d)),
                                     device=y.device)
    _, (dW, db) = fused_ark_step_adj(tab, dt, ys, seed, J, inv, Ws, bs, act,
                                     sign)
    chain = layout.pack(dW, db)
    diff = y1 - tgt
    chain_loss = float((diff * diff).sum()) / (B * d)
    torch.cuda.synchronize()
    bits = (bitwise(one, again), bitwise(one, half),
            torch.equal(one[1], chain))
    log(f"[kernels]   fused_grad_step {label}: plan {plan} (rows 0: the grid "
        f"form), workspace {ws} B; loss and gradient bitwise across two "
        f"calls {bits[0]}, across grids {plan[1]} and {plan[1] // 2} "
        f"{bits[1]}; the gradient bitwise equal to the K2 -> seed -> K3 "
        f"chain's {bits[2]} (max abs {abs_err(one[1], chain):.3e}); loss "
        f"{float(one[0]):.9e}, the chain's y1 summed by torch "
        f"{chain_loss:.9e}")
    if not all(bits):
        raise AssertionError(f"K12's grid form {label} is not bitwise "
                             "stable, or not the K2 -> seed -> K3 chain's")
    kern = lambda: fused_grad_step(*args)  # noqa: E731
    row = lambda: fused_grad_step(*args, rows=1)  # noqa: E731
    t = time_in_turns({"plain": lambda: fused_grad_step_plain(*args),
                       "kernel": kern, "row R 1": row}, reps=5, inner=4)
    dev, traced = device_us_per_call(kern, ["grad_step_grid_kernel"], n=5)
    dev_row = device_us_per_call(row, ["grad_step_kernel",
                                       "grad_step_sum_kernel"], n=5)[0]
    peak, peak_row = peak_bytes(kern), peak_bytes(row)
    total = layout.total
    log(f"[kernels]   fused_grad_step {label}: kernel {t['kernel']:.4f} ms "
        f"(device {dev / 1e3:.4f} ms, {traced} traced), plain "
        f"{t['plain']:.4f} ms; the row form at R 1 {t['row R 1']:.4f} ms "
        f"(device {dev_row / 1e3:.4f} ms), in turns; device memory a call "
        f"allocates: grid form {peak / 1e6:.1f} MB, row form "
        f"{peak_row / 1e6:.1f} MB ("
        + burgers_partials("the row form's", B, -(-(total + 1) // 4) * 4)
        + ")")
    return dict(ms=t["kernel"], plain_ms=t["plain"], device_ms=dev / 1e3,
                form="grid", grid=plan[1], smem_bytes=plan[2],
                workspace_bytes=ws, peak_bytes=peak, row_r1_ms=t["row R 1"],
                row_r1_device_ms=dev_row / 1e3, row_r1_peak_bytes=peak_row)


def wide_case(device, B, d, seed=6):
    """K12 operands past the staged operators' reach: J = -2 A A^T / d and
    ARK3's stage inverse at the main path's dt, one d-wide hidden layer,
    states ~ N(0, 1) and targets 0.05 from them: (J, inv, Ws, bs, y,
    tgt)."""
    import torch

    from pnode_tpu_torch.tableaus import get_ark_tableau

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device=device)
    A = rng.normal(size=(d, d))
    J64 = -2.0 * (A @ A.T) / d
    gamma = [g for g in np.diag(get_ark_tableau("3").a_im) if g != 0.0][0]
    inv = np.linalg.inv(np.eye(d) - float(np.float32(DT)) * gamma * J64)
    Ws = [f32(rng.normal(0.0, d ** -0.5, size=(d, d))) for _ in range(2)]
    bs = [f32(rng.normal(0.0, 0.1, size=d)) for _ in range(2)]
    y = rng.normal(size=(B, d))
    return (f32(J64), f32(inv), Ws, bs, f32(y),
            f32(y + 0.05 * rng.normal(size=(B, d))))


def phase_grad_step(device, u, J, inv, tab, dt):
    """Phase 8(a): K12 at the shards of world 1, 2, 4 and 8, at the
    ragged size and at d 200 (inv and J read in place), then per call at
    B_local 256 in turns with its plain version."""
    from pnode_tpu_torch.ops.fused_train_loop import (
        fused_grad_step, fused_grad_step_plain)

    report = {}
    log("[dp] (a) K12 (fused_grad_step) against its plain version")
    for B in DP_SHARDS:
        Ws, bs, y, tgt = loop_case(device, u, B, HIDDEN, False, 1, 1)
        args = check_grad_step(f"B_local {B} h{HIDDEN}", tab, dt, J, inv, Ws,
                               bs, y[0], tgt[0], report)
        if B == BATCH:
            main_args = args
    Ws, bs, y, tgt = loop_case(device, u, 37, 24, True, 2, 1)
    check_grad_step("B37 h24 biased", tab, dt, J, inv, Ws, bs, y[0], tgt[0],
                    report)
    check_grad_step("B37 d 200 (inv, J in place)", tab, dt,
                    *wide_case(device, 37, 200), report)
    fns = (lambda: fused_grad_step_plain(*main_args),
           lambda: fused_grad_step(*main_args))
    t = [summary(cuda_times_ms(fns[i], reps=20))[0] for i in (0, 1, 1, 0)]
    report["ms"], report["plain_ms"] = min(t[1], t[2]), min(t[0], t[3])
    us, traced = device_us_per_call(fns[1], ["grad_step_kernel",
                                             "grad_step_sum_kernel"])
    report["device_ms"] = us / 1e3
    log(f"[dp]   fused_grad_step per call at B_local {BATCH}: kernel "
        f"{t[1]:.4f} / {t[2]:.4f} ms (device {us:.2f} us, {traced} launches "
        f"traced), plain {t[0]:.4f} / {t[3]:.4f} ms; "
        f"{partial_bytes(BATCH, HIDDEN, grad=True)}")
    report["ks_grid"] = ks_grid_reading(main_args)
    return report


def ks_grid_reading(args):
    """K12's and K2's grid form at the KS main path (B 256 on ``args``,
    check_grad_step's), which their plans never take there (run_*'s form
    "grid"), beside the row form the plans take: each against its plain
    version in fp32 and fp64 with phase 3's gates, K2's y1 and Ys bitwise
    the row form's; then timed in turns and by the profiler: the reading
    for or against a later change dropping the row bodies. Returns
    {"k2": ..., "k12": ...}."""
    from pnode_tpu_torch.ops.fused_ark_forward import fused_ark_step_fwd_plain
    from pnode_tpu_torch.ops.fused_train_loop import fused_grad_step_plain

    layout, tab, dt, y, tgt, J, inv, params, act, sign = args
    Ws, bs = layout.unpack(params)
    d64 = lambda ts: [t.double() for t in ts]  # noqa: E731
    fargs = (tab, None, dt, y, J, inv, Ws, bs, act, sign)
    cases = {
        "k2": dict(
            run=lambda **kw: fwd_at(**kw)(*fargs), tol=1e-5,
            plain=fused_ark_step_fwd_plain(tab, dt, y, J, inv, Ws, bs, act,
                                           sign),
            ref=fused_ark_step_fwd_plain(tab, dt, y.double(), J.double(),
                                         inv.double(), d64(Ws), d64(bs), act,
                                         sign),
            names=(["ark_fwd_kernel"], ["ark_fwd_grid_kernel"])),
        "k12": dict(
            run=lambda **kw: grad_at(**kw)(*args), tol=1e-4,
            plain=fused_grad_step_plain(*args),
            ref=fused_grad_step_plain(layout, tab, dt, y.double(),
                                      tgt.double(), J.double(), inv.double(),
                                      params.double(), act, sign),
            names=(["grad_step_kernel", "grad_step_sum_kernel"],
                   ["grad_step_grid_kernel"]))}
    out = {}
    for name, c in cases.items():
        row = lambda c=c: c["run"]()  # noqa: E731
        grid = lambda c=c: c["run"](form="grid")  # noqa: E731
        got = grid()
        check_kernel(f"{name.upper()} at KS B {y.shape[0]} in the grid form",
                     list(got), list(c["plain"]), list(c["ref"]), c["tol"],
                     {})
        if name == "k2" and not bitwise(got, row()):
            raise AssertionError("K2's grid form at KS is not the row "
                                 "form's bitwise")
        t = time_in_turns({"row": row, "grid": grid}, reps=10)
        dev_row = device_us_per_call(row, c["names"][0])[0]
        dev_grid = device_us_per_call(grid, c["names"][1])[0]
        out[name] = dict(row_ms=t["row"], grid_ms=t["grid"],
                         row_device_ms=dev_row / 1e3,
                         grid_device_ms=dev_grid / 1e3)
        log(f"[dp]   {name.upper()} at KS B {y.shape[0]}: the row form (its "
            f"plan) {t['row']:.4f} ms (device {dev_row / 1e3:.4f} ms), the "
            f"grid form {t['grid']:.4f} ms (device {dev_grid / 1e3:.4f} ms), "
            "in turns")
    return out


def dp_rank(device, tab, dt, ops, Ws, bs, y, tgt, timed, burgers=None):
    """One rank of phase 8(b)-(d): dp_fused_train_loop over the group (a
    flat mesh of every rank) on the first DP_K minibatches at Adam eps
    1e-8 and 1e-6, from the given weights and zero moments, with K12's
    launch count over those runs. With ``timed`` (the one-rank NCCL group):
    the same call without force_general (K4 must launch, K12 must not), a
    traced call of 20 iterations on the general path (its busy share), and
    iterations per second of the general path and of K4 over DP_ITERS
    iterations (a warm call of 20, a timed call of the rest). With
    ``burgers`` (dp_burgers_rank's operands), first phase 8(f)'s rank in
    the same group, its result under "burgers"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pnode_tpu_torch.ops.fused_train_loop import (
        fused_grad_step, fused_train_loop)
    from pnode_tpu_torch.parallel import dp_fused_train_loop, make_mesh

    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device=device)
    out = {"runs": {}}
    if burgers is not None:
        out["burgers"] = dp_burgers_rank(device, *burgers)
    J, inv = f32(ops[0]), f32(ops[1])
    Ws, bs = [f32(w) for w in Ws], [f32(b) for b in bs]
    y, tgt = f32(y), f32(tgt)
    z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b) for b in bs])
    mesh = make_mesh()

    def run(k0, K, eps=1e-8, general=True):
        return dp_fused_train_loop(mesh, tab, dt, y[k0:k0 + K],
                                   tgt[k0:k0 + K], J, inv, Ws, bs, z, z, 0,
                                   lr=LR, eps=eps, force_general=general)

    fused_grad_step.launches = 0
    for eps in (1e-8, 1e-6):
        W, b, _, _, losses = run(0, DP_K, eps)
        out["runs"][eps] = (losses.cpu().numpy(),
                            [p.cpu().numpy() for p in W + b])
    torch.cuda.synchronize()
    out["launches"] = fused_grad_step.launches
    if not timed:
        return out
    fused_train_loop.launches = fused_grad_step.launches = 0
    run(0, DP_K, general=False)
    torch.cuda.synchronize()
    out["delegated"] = (fused_train_loop.launches, fused_grad_step.launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(0, 20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, busy_us = device_kernels(prof.events())
    out["traced"] = (wall / 20, busy_us * 1e-6 / wall, len(kernels))
    for name, general in (("general", True), ("K4", False)):
        run(0, 20, general=general)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(20, DP_ITERS - 20, general=general)
        torch.cuda.synchronize()
        out[name] = (DP_ITERS - 20) / (time.perf_counter() - t0)
    return out


def phase_dp_loops(device, u, J, inv, tab, dt, worlds, burgers, tol=5e-4):
    """Phase 8(b)-(d): dp_fused_train_loop in spawned groups of ranks,
    ``worlds`` (world size, backend) pairs: a one-rank NCCL group
    (force_general; with (b)'s delegation check and (d)), and gloo groups
    of 2 and 4 processes on the one card. Each rank against K4 on the full
    batch in phase 4(a)'s form (runs_agree), the parameters bitwise equal
    across ranks. The groups of 1 and 2 ranks also run 8(f) on
    ``burgers`` (dp_burgers_case's), gated by check_dp_burgers. Returns
    K12's launch count over the groups' DP_K-iteration runs, and over
    8(f)'s."""
    import torch

    from pnode_tpu_torch.ops.fused_train_loop import fused_train_loop
    from pnode_tpu_torch.parallel import run_ranks

    Ws, bs, y, tgt = loop_case(device, u, BATCH, HIDDEN, False, 3, DP_ITERS)
    z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b) for b in bs])
    ref = {}
    for eps in (1e-8, 1e-6):
        W, b, _, _, losses = fused_train_loop(tab, dt, y[:DP_K], tgt[:DP_K], J,
                                              inv, Ws, bs, z, z, 0, lr=LR,
                                              eps=eps)
        ref[eps] = (losses.cpu(), [t.cpu() for t in W + b])
    np_ = lambda ts: [t.cpu().numpy() for t in ts]  # noqa: E731
    launches, b_launches, ok = 0, 0, True
    for world, backend in worlds:
        K = DP_ITERS if world == 1 else DP_K
        with_b = world in (1, 2)
        t0 = time.perf_counter()
        ranks = run_ranks(world, dp_rank, tab, dt, np_([J, inv]), np_(Ws),
                          np_(bs), y[:K].cpu().numpy(), tgt[:K].cpu().numpy(),
                          world == 1, burgers[0] if with_b else None,
                          backend=backend, device=device, timeout=300.0)
        log(f"[dp] ({'b' if world == 1 else 'c'}) world {world} over "
            f"{backend} on the one card ({time.perf_counter() - t0:.1f} s "
            f"with the spawn{' and 8(f)' if with_b else ''}): K12 launches "
            f"per rank {[r['launches'] for r in ranks]}")
        if with_b:
            b_launches += check_dp_burgers(
                world, backend, [r["burgers"] for r in ranks], burgers[1])
        launches += sum(r["launches"] for r in ranks)
        for eps, (lk, pk) in ranks[0]["runs"].items():
            same = all(np.array_equal(lk, r["runs"][eps][0]) and all(
                np.array_equal(a, b) for a, b in zip(pk, r["runs"][eps][1]))
                for r in ranks[1:])
            log(f"[dp]     Adam eps {eps:.0e}: losses and parameters "
                f"{'bitwise equal' if same else 'DIFFERENT'} across the "
                f"{world} rank(s)")
            agree = runs_agree(
                f"K4 on the full batch (world {world})", eps,
                (torch.from_numpy(lk), [torch.from_numpy(a) for a in pk]),
                ref[eps], tol)
            ok = ok and same and agree
        if world == 1:
            r = ranks[0]
            k4, k12 = r["delegated"]
            step, busy, n_kern = r["traced"]
            log(f"[dp] (b) without force_general: K4 launches {k4}, K12 "
                f"launches {k12}")
            log(f"[dp] (d) general path (K12 + NCCL all-reduce + Adam), one "
                f"rank: traced call of 20 iterations {1e3 * step:.3f} ms/"
                f"iteration, device busy {busy:.3f} of the wall time "
                f"({n_kern} device events); {r['general']:.1f} iterations/s "
                f"beside K4's {r['K4']:.1f} over {DP_ITERS - 20} iterations "
                f"(one call each, after a warm call of 20)")
            ok = ok and k4 > 0 and k12 == 0
    if not ok:
        raise AssertionError("dp_fused_train_loop disagrees with K4, or its "
                             "ranks with each other")
    return launches, b_launches


def dp_burgers_rank(device, tab, dt, ops, Ws, bs, y, tgt):
    """Phase 8(f)'s rank: dp_fused_train_loop with force_general (K12 on
    the rank's shard of B 200, the all-reduce and Adam outside it) over the
    minibatches of y and tgt one iteration a call, at Adam eps 1e-8 and
    1e-6, and at each iteration K4 one step on the full batch from the
    same state. Returns per eps the DP run's losses and final parameters
    and the largest per-step gaps (loss relative, parameters max abs and
    norm-wise per tensor), and K12's launches; at world 1 also the
    iterations/s of the DP loop and of K4 over DP_BURGERS_ITERS
    iterations (the minibatches repeated; one call each after a warm
    one)."""
    import torch

    from pnode_tpu_torch.ops.fused_train_loop import (
        fused_grad_step, fused_train_loop)
    from pnode_tpu_torch.parallel import dp_fused_train_loop, make_mesh

    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device=device)
    J, inv = f32(ops[0]), f32(ops[1])
    Ws, bs = [f32(w) for w in Ws], [f32(b) for b in bs]
    y, tgt = f32(y), f32(tgt)
    mesh = make_mesh()
    out = {"runs": {}, "steps": {}}
    fused_grad_step.launches = 0
    for eps in (1e-8, 1e-6):
        z = ([torch.zeros_like(w) for w in Ws],
             [torch.zeros_like(b) for b in bs])
        state, losses, gaps = (Ws, bs, z, z), [], [0.0, 0.0, 0.0]
        for k in range(y.shape[0]):
            args = (tab, dt, y[k:k + 1], tgt[k:k + 1], J, inv, *state, k)
            kw = dict(sign=1.0, lr=LR, eps=eps)
            W, b, m, v, loss = dp_fused_train_loop(mesh, *args, **kw,
                                                   force_general=True)
            W4, b4, _, _, loss4 = fused_train_loop(*args, **kw)
            gaps = [max(gaps[0], rel_max(loss, loss4)),
                    max(gaps[1], max(abs_err(a, c)
                                     for a, c in zip(W + b, W4 + b4))),
                    max(gaps[2], norm_rel(W + b, W4 + b4))]
            losses.append(float(loss[0]))
            state = (W, b, m, v)
        out["runs"][eps] = (np.array(losses),
                            [p.cpu().numpy() for p in state[0] + state[1]])
        out["steps"][eps] = gaps
    torch.cuda.synchronize()
    out["launches"] = fused_grad_step.launches
    if torch.distributed.get_world_size() == 1:
        n = DP_BURGERS_ITERS
        reps = -(-n // y.shape[0])
        yr, tr = torch.cat([y] * reps)[:n], torch.cat([tgt] * reps)[:n]
        z = ([torch.zeros_like(w) for w in Ws],
             [torch.zeros_like(b) for b in bs])
        for name, general in (("general", True), ("K4", False)):
            for k in (y.shape[0], n):  # a warm call, then the timed one
                t0 = time.perf_counter()
                dp_fused_train_loop(mesh, tab, dt, yr[:k], tr[:k], J, inv,
                                    Ws, bs, z, z, 0, sign=1.0, lr=LR,
                                    force_general=general)
                torch.cuda.synchronize()
            out[name] = n / (time.perf_counter() - t0)
    return out


def dp_burgers_case(device):
    """Phase 8(f)'s operands on bench.py's Burgers recipe
    (burgers_operators, f_EX = +MLP, fresh minibatches y ~ N(0, 1), target
    y + 0.05 N(0, 1)), as dp_burgers_rank takes them (numpy), and K4's
    own runs over the same DP_K batches at Adam eps 1e-8 and 1e-6 on the
    full batch (the counterpart of ``bench.py --workload burgers --dp``):
    (rank operands, {eps: (losses, params)})."""
    import torch

    from pnode_tpu_torch.ops.fused_train_loop import fused_train_loop

    J, inv, tab, Ws, bs = burgers_operators(device)
    dt = float(np.float32(BDT))
    pairs = burgers_batches(DP_K, seed=8)
    y, tgt = (np.stack([p[i] for p in pairs]) for i in (0, 1))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device=device)
    z = ([torch.zeros_like(w) for w in Ws], [torch.zeros_like(b) for b in bs])
    ref = {}
    for eps in (1e-8, 1e-6):
        W, b, _, _, losses = fused_train_loop(tab, dt, f32(y), f32(tgt), J,
                                              inv, Ws, bs, z, z, 0, sign=1.0,
                                              lr=LR, eps=eps)
        ref[eps] = (losses.cpu(), [t.cpu() for t in W + b])
    np_ = lambda ts: [t.cpu().numpy() for t in ts]  # noqa: E731
    return (tab, dt, np_([J, inv]), np_(Ws), np_(bs), y, tgt), ref


def check_dp_burgers(world, backend, ranks, ref, tol=5e-4):
    """Phase 8(f)'s gates on one group's dp_burgers_rank results: the DP
    loop with force_general (K12 on each rank's shard of B 200) against K4
    on the full batch: per iteration, K4 one step from the DP loop's state,
    the loss within 1e-4 relative and the parameters within ``tol`` in max
    abs at eps 1e-8 and norm-wise per tensor at eps 1e-6 (check_loop's
    gates); the free runs against K4's own run (``ref``) in phase 7(b)'s
    form (burgers_runs_agree), the parameters at eps 1e-8 printed only: a
    run that sums dW in another order parts at eps 1e-8, where Adam
    carries the rounding on to parts of ~5e-3 of the stack in 8 iterations
    at Burgers (PERF.md); the ranks' losses and parameters bitwise equal;
    K12 launched on every rank. Returns K12's launches over the ranks."""
    import torch

    rank = ranks[0]
    log(f"[dp] (f) Burgers-512 (B {BB}, dt {BDT}), world {world} over "
        f"{backend} on the one card, force_general (K12 at B "
        f"{BB // world}): K12 launches per rank "
        f"{[r['launches'] for r in ranks]}")
    ok = all(r["launches"] > 0 for r in ranks)
    if world == 1:
        log(f"[dp]     the DP loop (K12 + all-reduce + Adam) "
            f"{rank['general']:.1f} iterations/s beside K4's "
            f"{rank['K4']:.1f} over {DP_BURGERS_ITERS} iterations (one call "
            f"each, after a warm call)")
    for eps, (lk, pk) in rank["runs"].items():
        lrel, pabs, prel = rank["steps"][eps]
        good = lrel <= 1e-4 and (pabs if eps == 1e-8 else prel) <= tol
        same = all(np.array_equal(lk, r["runs"][eps][0]) and all(
            np.array_equal(a, b) for a, b in zip(pk, r["runs"][eps][1]))
            for r in ranks[1:])
        log(f"[dp]     Adam eps {eps:.0e}, K4 one step from each of the DP "
            f"loop's {DP_K} states: loss max rel err {lrel:.3e} (tol 1e-4), "
            f"params max abs {pabs:.3e}, rel (norm-wise per tensor) "
            f"{prel:.3e}; gated {'max abs' if eps == 1e-8 else 'rel'} at "
            f"{tol:.0e} {'ok' if good else 'FAIL'}; losses and parameters "
            f"{'bitwise equal' if same else 'DIFFERENT'} across the {world} "
            f"rank(s)")
        ok = burgers_runs_agree(
            f"K4's own run (world {world})", eps,
            (torch.from_numpy(lk), [torch.from_numpy(a) for a in pk]),
            ref[eps], params=eps != 1e-8) and good and same and ok
    if not ok:
        raise AssertionError("dp_fused_train_loop disagrees with K4 at "
                             "Burgers-512, or its ranks with each other")
    return sum(r["launches"] for r in ranks)


def start_ks_torch_dp(device):
    """Phase 8(e), started: torchrun --standalone --nproc_per_node 1
    examples/ks_torch.py --dp 1, and the same run without --dp, one epoch
    of 3 iterations each (batch 64 of 240 training states), side by side
    in their own directories. Returns {name: (command, process)}."""
    runs = {}
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    for name, head, tail in (
            ("dp", [sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc_per_node", "1"], ["--dp", "1"]),
            ("plain", [sys.executable], [])):
        cmd = head + ["examples/ks_torch.py", "--max_epochs", "1",
                      "--data_size", "300", "--batch_size", "64", "--device",
                      device, "--train_dir",
                      os.path.join(ROOT, "build", f"ks_torch_{name}"),
                      # the main path (the trainer's defaults until slice
                      # 4(b) set them to examples/ks.py's)
                      "--pnode_model", "imex", "--linear_solver", "hpddm",
                      "--fixed_jacobian"] + tail
        runs[name] = (cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=env))
    return runs


def finish_ks_torch_dp(runs, t0):
    """Phase 8(e), read: both runs' train losses, a finite loss within 1e-5
    relative of each other."""
    loss, out = {}, {}
    for name, (cmd, proc) in runs.items():
        try:
            out[name], err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"{' '.join(cmd)} timed out")
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(cmd)} failed ({proc.returncode})"
                                 f":\n{out[name][-2000:]}\n{err[-3000:]}")
        line = [ln for ln in out[name].splitlines() if ln.startswith("Epoch")]
        loss[name] = float(line[-1].split("Train")[1].split("|")[0])
    rel = abs(loss["dp"] - loss["plain"]) / abs(loss["plain"])
    log(f"[dp] (e) torchrun --standalone --nproc_per_node 1 "
        f"examples/ks_torch.py --dp 1 --batch_size 64 (3 iterations): train "
        f"loss {loss['dp']:.9e}, without --dp {loss['plain']:.9e}, rel "
        f"{rel:.3e} (tol 1e-5); both runs done {time.perf_counter() - t0:.1f}"
        f" s after their start")
    if "data-parallel: 1 device(s), 64 samples/device" not in out["dp"]:
        raise AssertionError("ks_torch.py --dp 1 did not start its mesh")
    if not (np.isfinite(loss["dp"]) and rel <= 1e-5):
        raise AssertionError("ks_torch.py --dp 1 disagrees with the run "
                             "without --dp")


def phase_dp(device, u):
    """Phase 8: the data-parallel slice. Returns K12's report, its launch
    count over (b) and (c), and its launches at Burgers-512 (f)."""
    import torch

    from pnode_tpu_torch.ops.fused_train_loop import fused_grad_step_cost

    J, inv, tab, _ = ks_operators(device)
    dt = float(np.float32(DT))
    t0 = time.perf_counter()
    report = phase_grad_step(device, u, J, inv, tab, dt)
    report["bound_ms"], report["bound_by"] = bound(*fused_grad_step_cost(
        tab, BATCH, NX, [HIDDEN] * 4 + [NX]))
    one = "nccl" if torch.device(device).type == "cuda" else "gloo"
    case = dp_burgers_case(device)  # (f) rides in (b)'s and (c)'s groups
    launches, burgers = phase_dp_loops(device, u, J, inv, tab, dt,
                                       ((1, one),), case)
    # (e) runs beside (c): neither is timed
    t_e = time.perf_counter()
    runs = start_ks_torch_dp(device)
    try:
        more, more_b = phase_dp_loops(device, u, J, inv, tab, dt,
                                      ((2, "gloo"), (4, "gloo")), case)
        launches += more
        burgers += more_b
        finish_ks_torch_dp(runs, t_e)
    finally:
        for _, proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    log(f"[dp] phase 8 in {time.perf_counter() - t0:.1f} s; K12 launches "
        f"over (b) and (c): {launches}")
    if launches <= 0:
        raise AssertionError("fused_grad_step was never launched on the "
                             "data-parallel path")
    return report, launches, burgers


# -- phase 9: the theta slice --------------------------------------------------

SNODE_B, SNODE_H, SNODE_STEPS = 128, 200, 5
# 9(d): burgers --node, one window of two outputs 0.1 apart, dopri5 at 1e-3
NODE_WINDOW, NODE_DT = 0.1, 1e-3


def phase_theta_stencil(device):
    """9(a): K10 and K11 under torch.func at the slice's stencils, the KS
    (128, 64) k 5 and the Burgers (200, 512) k 3 fixed stencils: jvp
    through K10 (its jvp rule: K10 on the tangent) bitwise equal to jvp
    through the roll chain; vjp through K11 bitwise equal to K11's plain
    version (the flipped stencil summed in tap order), and within 1e-6 of
    max |ref| of autograd's vjp through the roll chain, which sums the k
    shifted cotangents in another order."""
    import torch

    from pnode_tpu_torch.models import burgers_fixed_kernel, ks_fixed_kernel
    from pnode_tpu_torch.ops import circular_stencil as cs

    for label, rows, n, taps in (
            ("KS snode", SNODE_B, NX, ks_fixed_kernel(22.0 / NX)),
            ("Burgers", BB, BNX, burgers_fixed_kernel(1.0 / BNX))):
        y, v = stencil_case(device, rows, n, len(taps), 90 + rows)[:2]
        g = stencil_case(device, rows, n, len(taps), 91 + rows)[0]
        w = torch.tensor(taps, dtype=torch.float32, device=device)
        kern = lambda yy: cs.circular_stencil(yy, w)  # noqa: E731
        roll = lambda yy: cs.circular_stencil_plain(yy, w)  # noqa: E731
        out_k, jv_k = torch.func.jvp(kern, (y,), (v,))
        out_p, jv_p = torch.func.jvp(roll, (y,), (v,))
        (vt_k,) = torch.func.vjp(kern, y)[1](g)
        (vt_p,) = torch.func.vjp(roll, y)[1](g)
        dy_plain = cs.circular_stencil_bwd_plain(y, g, w, need_dw=False)[0]
        torch.cuda.synchronize()
        same = (bool(torch.equal(out_k, out_p)), bool(torch.equal(jv_k, jv_p)),
                bool(torch.equal(vt_k, dy_plain)))
        e_roll = rel_err(vt_k, vt_p)
        log(f"[theta] (a) {label} stencil ({rows}, {n}) k {len(taps)} under "
            f"torch.func: jvp through K10 {'equals' if all(same[:2]) else 'DIFFERS FROM'} "
            f"the roll chain's bitwise (primal and tangent); vjp through K11 "
            f"{'equals' if same[2] else 'DIFFERS FROM'} K11's plain version "
            f"bitwise, {e_roll:.3e} of max |ref| from autograd's vjp "
            "through the roll chain (tol 1e-6)")
        if not all(same) or e_roll > 1e-6:
            raise AssertionError(f"K10/K11 under torch.func disagree at the "
                                 f"{label} stencil")


class GMRESCounter:
    """Counts the GMRES solves and iterations of the stage solvers while it
    is entered (wraps linsolve.gmres): ``solves``/``iters``/``cycles`` by
    direction, "forward" (J v, the Newton iterations) and "transpose" (J^T
    v, the adjoint)."""

    def __init__(self):
        self.solves = {"forward": 0, "transpose": 0}
        self.iters = {"forward": 0, "transpose": 0}
        self.cycles = {"forward": 0, "transpose": 0}

    def __enter__(self):
        from pnode_tpu_torch import linsolve

        self._orig = linsolve.gmres
        orig = self._orig

        def counted(matvec, b, *args, **kw):
            res = orig(matvec, b, *args, **kw)
            way = ("transpose" if getattr(matvec, "__name__", "")
                   == "_apply_T" else "forward")
            m = min(kw.get("restart", 30), int(b.shape[0]))
            self.solves[way] += 1
            self.iters[way] += res.iters
            self.cycles[way] += res.iters // m
            return res

        linsolve.gmres = counted
        return self

    def __exit__(self, *exc):
        from pnode_tpu_torch import linsolve

        linsolve.gmres = self._orig
        return False


def snode_state(seed=0):
    """The KS snode model's seed weights (hidden 200), fp32 on the CPU."""
    import torch

    from pnode_tpu_torch.models import KSSnodeFunc

    mod = KSSnodeFunc(nx=NX, hidden=SNODE_H,
                      generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in mod.state_dict().items()}


def build_snode(device, state, fused, dtype=None):
    """(ode, module, Adam) of examples/ks_torch.py --pnode_model snode
    --pnode_method cn --linear_solver petsc --no-fixed_jacobian at batch
    128: CN, Newton (newtonls), matrix-free GMRES stage solves; the
    stencil on K10/K11 when ``fused``."""
    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.models import KSSnodeFunc

    dtype = dtype or torch.float32
    pt.clear_options()
    pt.init(["chip_smoke"])
    mod = KSSnodeFunc(nx=NX, hidden=SNODE_H, dtype=dtype, device=device,
                      use_fused=fused)
    mod.load_state_dict({k: v.to(dtype) for k, v in state.items()})
    ode = pt.ODESolver().setupTS(
        torch.zeros(SNODE_B, NX, dtype=dtype, device=device),
        pt.TorchFunc(mod), step_size=DT, method="cn", implicit_form=True,
        linear_solver="petsc", fixed_jacobian=False, batch_size=SNODE_B)
    return ode, mod, torch.optim.Adam(mod.parameters(), lr=LR)


def snode_grads(ode, mod, y0, tgt, dtype=None):
    """(loss, flat gradient) of one step's MSE through the discrete
    adjoint."""
    import torch

    dtype = dtype or torch.float32
    dev = next(mod.parameters()).device
    y0 = torch.as_tensor(y0, dtype=dtype, device=dev)
    tgt = torch.as_tensor(tgt, dtype=dtype, device=dev)
    for p in mod.parameters():
        p.grad = None
    pred = ode.odeint_adjoint(y0, np.array([0.0, DT]))
    loss = torch.mean((pred[-1] - tgt) ** 2)
    loss.backward()
    return float(loss.detach()), torch.cat(
        [p.grad.detach().reshape(-1).double().cpu()
         for p in mod.parameters()])


def phase_theta_gmres(device, u):
    """9(b): one GMRES stage solve of the snode's CN operator (I - dt/2 J)
    at a (128, 64) KS linearization point, rtol 1e-5 (the default
    -ksp_rtol): the residual within rtol; against a dense fp64 solve of the
    same operator per batch block, within cond(A) times twice rtol; the
    host reads of the solve (torch.cuda's sync debug mode): one before the
    first cycle and one after each."""
    import warnings

    import torch

    from pnode_tpu_torch.linsolve import (
        LinearSolveConfig, assemble_block_jacobian, make_stage_solver)

    state = snode_state()
    _, mod, _ = build_snode(device, state, True)
    _, mod64, _ = build_snode(device, state, False, torch.float64)
    y = torch.tensor(u[:SNODE_B], dtype=torch.float32, device=device)
    b = torch.tensor(np.random.default_rng(9).normal(size=SNODE_B * NX),
                     dtype=torch.float32, device=device)
    cfg = LinearSolveConfig(kind="gmres", rtol=1e-5, block_size=NX)
    gamma = 0.5 * DT

    def f_flat(m):
        return lambda zf: m(DT, zf.reshape(SNODE_B, NX)).reshape(-1)

    def sync_reads(fn):
        """(fn(), the synchronizing calls torch.cuda's sync check reports
        while it runs, as "file:line message")."""
        seen = []

        def note(message, category, filename, lineno, *rest):
            if "called a synchronizing CUDA operation" in str(message):
                seen.append(f"{os.path.basename(filename)}:{lineno} "
                            f"{str(message)[:60]!r}")

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, seen

    with torch.no_grad():  # a stage solve records no graph
        solver = make_stage_solver(f_flat(mod), y.reshape(-1), None, 1.0,
                                   gamma, cfg)
        solver.solve(b)  # a warm pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, seen = sync_reads(lambda: solver.solve(b))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    syncs = len(seen)
    log(f"[theta] (b) the sync check's reports over the solve: "
        f"{'; '.join(seen)}")
    res = solver.last
    m = min(cfg.restart, SNODE_B * NX)
    cycles = res.iters // m
    with torch.no_grad():
        J = assemble_block_jacobian(f_flat(mod64), y.double().reshape(-1),
                                    cfg, shared=False)
        A = torch.eye(NX, dtype=torch.float64, device=device) - gamma * J
        b64 = b.double().reshape(SNODE_B, NX)
        x64 = torch.linalg.solve(A, b64)
        xg = x.double().reshape(SNODE_B, NX)
        resid = float((b64 - torch.einsum("bij,bj->bi", A, xg)).norm()
                      / b64.norm())
        err = float((xg - x64).norm() / x64.norm())
        cond = float(torch.linalg.cond(A).max())
    log(f"[theta] (b) GMRES stage solve of the snode CN operator at B "
        f"{SNODE_B}, n {SNODE_B * NX}: {res.iters} iterations in {cycles} "
        f"cycles of {m}, converged {res.converged}, {ms:.2f} ms (host "
        f"clock, with torch.cuda's sync check on); relative residual in "
        f"fp64 {resid:.3e} (rtol {cfg.rtol:.0e}); against the dense fp64 "
        f"solve {err:.3e} (max block cond {cond:.1f}, tol "
        f"{2 * cfg.rtol * cond:.3e}); host syncs in the solve {syncs} "
        f"(allowed: {cycles + 1}, one norm read before the first cycle and "
        "after each)")
    if not (res.converged and resid <= 2 * cfg.rtol
            and err <= 2 * cfg.rtol * cond and syncs <= cycles + 1):
        raise AssertionError("the GMRES stage solve on the card failed its "
                             "checks")
    return {"iters": res.iters, "cycles": cycles, "ms": ms}


def phase_theta_snode(device, u):
    """9(c): the snode CN + GMRES trainer at full width (hidden 200, batch
    128, dt 0.2, Adam lr 5e-3, KS windows): at step 1 the kernel path
    (the stencil on K10/K11) against the plain path (the roll chain) on the
    card, loss and gradient within 1e-4 relative, and the gradient's cosine
    against the port's CPU fp64 run >= 0.999 (tools/hardware_smoke.py's
    gate 4); then 5 Adam steps on the kernel path: finite losses, the last
    below the first, steps/s, Newton and GMRES iterations per step; K10's
    and K11's launches over the 5 steps above 0; one traced step's device
    busy share."""
    import torch

    from pnode_tpu_torch.ops.circular_stencil import (
        circular_stencil_bwd, circular_stencil_fwd)

    state = snode_state()
    batches = ks_batches(u, SNODE_STEPS + 1, SNODE_B, seed=11)
    y0, tgt = batches[0]
    ode_k, mod_k, opt_k = build_snode(device, state, True)
    ode_p, mod_p, _ = build_snode(device, state, False)
    l_k, g_k = snode_grads(ode_k, mod_k, y0, tgt)
    l_p, g_p = snode_grads(ode_p, mod_p, y0, tgt)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    try:
        ode_c, mod_c, _ = build_snode("cpu", state, False, torch.float64)
        t0 = time.perf_counter()
        l_c, g_c = snode_grads(ode_c, mod_c, y0, tgt, torch.float64)
        cpu_s = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    e_loss = abs(l_k - l_p) / abs(l_p)
    e_grad = norm_err(g_k, g_p)
    cos = float(torch.dot(g_k, g_c) / (g_k.norm() * g_c.norm()))
    log(f"[theta] (c) snode CN + GMRES, B {SNODE_B}, hidden {SNODE_H}, step "
        f"1: kernel path vs plain path loss {e_loss:.3e}, gradient "
        f"{e_grad:.3e} norm-wise (tol 1e-4); cosine against the CPU fp64 "
        f"run {cos:.6f} (tol 0.999; loss {l_k:.6e} vs {l_c:.6e}; the CPU "
        f"run took {cpu_s:.1f} s)")
    if not (e_loss <= 1e-4 and e_grad <= 1e-4 and cos >= 0.999):
        raise AssertionError("the snode CN kernel path disagrees with the "
                             "plain path or the CPU fp64 run")

    ode, mod, opt = build_snode(device, state, True)
    circular_stencil_fwd.launches = circular_stencil_bwd.launches = 0
    losses, newton = [], 0
    with GMRESCounter() as cnt:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for y0, tgt in batches[1:]:
            y0 = torch.as_tensor(y0, dtype=torch.float32, device=device)
            tgt = torch.as_tensor(tgt, dtype=torch.float32, device=device)
            pred = ode.odeint_adjoint(y0, np.array([0.0, DT]))
            loss = torch.mean((pred[-1] - tgt) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            newton += ode.last_stats.newton_iters
            losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {"circular_stencil_fwd": circular_stencil_fwd.launches,
              "circular_stencil_bwd": circular_stencil_bwd.launches}
    n = len(losses)
    log(f"[theta] (c) {n} Adam steps on the kernel path: losses "
        f"{', '.join(f'{x:.6e}' for x in losses)}; {n / wall:.3f} steps/s; "
        f"per step {newton / n:.1f} Newton iterations, GMRES "
        f"{cnt.iters['forward'] / n:.1f} iterations ({cnt.solves['forward'] / n:.1f} "
        f"solves, {cnt.cycles['forward'] / n:.1f} cycles) forward and "
        f"{cnt.iters['transpose'] / n:.1f} ({cnt.solves['transpose'] / n:.1f} "
        f"solves) transposed; launches {counts}")
    busy = profile_steps("snode CN + GMRES kernel path", ode, mod, opt,
                         batches[1:2], device, DT, focus=("stencil", "K10/K11"))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("the snode CN trainer did not lower its loss")
    if min(counts.values()) <= 0:
        raise AssertionError("K10 or K11 was never launched on the snode CN "
                             "path")
    return counts, {"steps_per_s": n / wall, "newton": newton / n,
                    "gmres_fwd": cnt.iters["forward"] / n,
                    "gmres_T": cnt.iters["transpose"] / n, "busy": busy}


def phase_theta_burgers_node(device):
    """9(d): examples/burgers_torch.py --node's computation at full width
    (B 200, nx 512, f_EX 512 -> 576 x4 -> 512): f_IM + f_EX by dopri5 at
    1e-3 over one window of two outputs (100 steps), the mean-abs loss
    differentiated by autograd through the steps. The kernel path (f_EX on
    K1, f_IM on K10/K11) against the plain path (nn.Linear, the roll
    chain) from the same weights and batch: loss and gradient within 1e-4
    relative (the gradient norm-wise); K1's, K10's and K11's launches
    above 0; iterations/s of both paths; peak device memory."""
    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.models import BurgersFuncEX, BurgersFuncIM, IMEXSum
    from pnode_tpu_torch.ops.circular_stencil import (
        circular_stencil_bwd, circular_stencil_fwd)
    from pnode_tpu_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_fwd

    init = BurgersFuncEX(nx=BNX, use_fused=True, device=device,
                         generator=torch.Generator(device=device).manual_seed(0))
    state0 = {k: v.detach().clone() for k, v in init.state_dict().items()}
    y0, tgt = burgers_batches(1, seed=3)[0]
    window = np.array([0.0, NODE_WINDOW])

    def build(fused):
        pt.clear_options()
        im = BurgersFuncIM(nx=BNX, use_fused=fused, device=device)
        ex = BurgersFuncEX(nx=BNX, use_fused=fused, device=device)
        ex.load_state_dict(state0 if fused else to_linear_state(state0))
        ode = pt.ODESolver().setupTS(
            torch.zeros(BB, BNX, device=device), pt.TorchFunc(IMEXSum(im, ex)),
            step_size=NODE_DT, method="dopri5", enable_adjoint=False)
        return ode, ex

    def grad_step(ode, ex):
        for p in ex.parameters():
            p.grad = None
        pred, _ = ode.solve(torch.as_tensor(y0, device=device), window,
                            with_adjoint=False)
        target = torch.stack([torch.as_tensor(y0, device=device),
                              torch.as_tensor(tgt, device=device)])
        loss = torch.mean(torch.abs(pred - target))
        loss.backward()
        return float(loss.detach()), fused_layout(ex, grads=True)

    wrappers = (fused_mlp_fwd, fused_mlp_bwd, circular_stencil_fwd,
                circular_stencil_bwd)
    for w in wrappers:
        w.launches = 0
    ode_k, ex_k = build(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    l_k, g_k = grad_step(ode_k, ex_k)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counts = {w.__name__: w.launches for w in wrappers}
    ode_p, ex_p = build(False)
    l_p, g_p = grad_step(ode_p, ex_p)
    e_loss = abs(l_k - l_p) / abs(l_p)
    flat = lambda gs: torch.cat([g.reshape(-1).double() for g in gs])  # noqa
    e_grad = norm_err(flat(g_k), flat(g_p))
    e_max = max(norm_err(a, b) for a, b in zip(g_k, g_p))
    times = {}
    for label, ode, ex in (("plain", ode_p, ex_p), ("kernel", ode_k, ex_k),
                           ("kernel ", ode_k, ex_k), ("plain ", ode_p, ex_p)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad_step(ode, ex)
        torch.cuda.synchronize()
        times.setdefault(label.strip(), []).append(time.perf_counter() - t0)
    n_steps = int(round(NODE_WINDOW / NODE_DT))
    log(f"[theta] (d) Burgers --node, B {BB}, nx {BNX}, dopri5 at {NODE_DT} "
        f"over {n_steps} steps: loss {l_k:.6e}; kernel vs plain path loss "
        f"{e_loss:.3e}, gradient {e_grad:.3e} norm-wise over the stack "
        f"(per tensor max {e_max:.3e}; tol 1e-4); one iteration (forward "
        f"and autograd backward) {min(times['kernel']):.3f} s on the kernel "
        f"path ({1 / min(times['kernel']):.3f} iterations/s), "
        f"{min(times['plain']):.3f} s on the plain path (in turns, best of "
        f"two); peak device memory of the kernel path's iteration "
        f"{peak / 2**30:.3f} GiB; launches {counts}")
    if not (e_loss <= 1e-4 and e_grad <= 1e-4):
        raise AssertionError("Burgers --node's kernel path disagrees with "
                             "its plain path")
    if min(counts.values()) <= 0:
        raise AssertionError("K1, K10 or K11 was never launched on the "
                             "Burgers --node path")
    return counts, {"iter_s": min(times["kernel"]),
                    "plain_iter_s": min(times["plain"]),
                    "peak_gib": peak / 2**30}


def phase_theta_pendulum(device, n_iters=4):
    """9(e): examples/pendulum_dae_torch.py through its main() (M =
    diag(1,1,1,1,0), CN with GMRES through the mass matrix, AdamW), 4
    iterations on the card at its default fp32 (~6 s each): finite
    losses, the last below the first, the constraint violation reports;
    the first loss within 1e-5 relative of the port's CPU fp64 run's (the
    trainer draws its weights in fp64 from a CPU generator, so both runs
    start from the same net)."""
    import torch

    import pnode_tpu_torch as pt

    pend = load_example("pendulum_dae_torch")
    train_dir = os.path.join(ROOT, "build", "pendulum_dae_torch")

    def run(dev, n, *flags):
        pt.clear_options()
        return pend.main(["--device", dev, "--niters", str(n), "--test_freq",
                          "5", "--train_dir", train_dir, *flags])

    t0 = time.perf_counter()
    out = run(device, n_iters)
    wall = time.perf_counter() - t0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # more threads only slow its tiny ops
    try:
        cpu64 = run("cpu", 1, "--double_prec")["losses"][0]
    finally:
        torch.set_num_threads(threads)
    losses = out["losses"]
    e_first = abs(losses[0] - cpu64) / abs(cpu64)
    log(f"[theta] (e) pendulum_dae_torch, {n_iters} iterations on the card "
        f"in {wall:.1f} s (data included), fp32: loss {losses[0]:.6e} -> "
        f"{losses[-1]:.6e}; first loss against the CPU fp64 run "
        f"{cpu64:.6e}: {e_first:.3e} relative (tol 1e-5); constraint "
        "violation " + ", ".join(f"iter {i} {cv:.3e}" for i, cv in out["cv"]))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]
            and e_first <= 1e-5):
        raise AssertionError("the pendulum DAE trainer failed its checks")
    return {"iters_per_s": n_iters / wall, "first": losses[0],
            "last": losses[-1]}


def phase_theta(device, u):
    """Phase 9: the theta slice. Returns the launches of K1, K10 and K11
    over its paths, by path."""
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[theta] the theta slice on {smi.splitlines()[0]}")
    phase_theta_stencil(device)
    gm = phase_theta_gmres(device, u)
    snode_counts, sn = phase_theta_snode(device, u)
    node_counts, nd = phase_theta_burgers_node(device)
    pend = phase_theta_pendulum(device)
    log(f"[theta] phase 9 took {time.perf_counter() - t0:.1f} s")
    launches = {}
    for name, c in snode_counts.items():
        launches.setdefault(name, {})["snode_cn"] = c
    for name, c in node_counts.items():
        launches.setdefault(name, {})["burgers_node"] = c
    return launches, {"gmres": gm, "snode": sn, "node": nd,
                      "pendulum": pend}



# -- phase 10: trajectory policies, the new drivers, the trainers' defaults ----

TRAJ_STEPS, TRAJ_EVERY, TRAJ_CPS = 100, 10, 8
REPLAY_NAMES = {"fused_mlp_fwd": ("K1 fwd",), "fused_mlp_bwd": ("K1 bwd",),
                "fused_ark_step_fwd": ("K2",),
                "fused_ark_step_adj": ("K3", "K3 sum")}
TRAJ_POLICIES = {
    "store_all": [],
    "solution_only": ["-ts_trajectory_solution_only", "1"],
    "checkpoint": ["-ts_trajectory_max_cps_ram", str(TRAJ_CPS)],
    "revolve": ["-ts_trajectory_max_cps_ram", str(TRAJ_CPS),
                "-ts_trajectory_schedule", "revolve"],
    "cams": ["-ts_trajectory_max_cps_ram", str(TRAJ_CPS),
             "-ts_trajectory_schedule", "cams"],
}


class StepCounter:
    """Counts ARKIMEX's steps while entered (class-level wrappers, so the
    copies ``prepare`` makes count too): ``steps`` outside ``step_adj``
    (the original pass and the engine's re-steps) apart from ``inner``,
    the stage recomputes that ``step_adj(aux=None)`` runs inside itself."""

    def __enter__(self):
        from pnode_tpu_torch.steppers import ARKIMEX

        self.steps = self.inner = 0
        self._depth = 0
        self._orig = (ARKIMEX.step, ARKIMEX.step_adj)
        step, step_adj = self._orig
        counter = self

        def counted_step(stp, *a, **k):
            if counter._depth:
                counter.inner += 1
            else:
                counter.steps += 1
            return step(stp, *a, **k)

        def counted_adj(stp, *a, **k):
            counter._depth += 1
            try:
                return step_adj(stp, *a, **k)
            finally:
                counter._depth -= 1

        ARKIMEX.step, ARKIMEX.step_adj = counted_step, counted_adj
        return self

    def __exit__(self, *exc):
        from pnode_tpu_torch.steppers import ARKIMEX

        ARKIMEX.step, ARKIMEX.step_adj = self._orig


def traj_case(u, batch=BATCH, seed=7):
    """(y0, targets (10, B, 64), output times): a 100-step window of dt 0.2
    from the KS data, outputs at every 10th step."""
    rng = np.random.default_rng(seed)
    s = rng.choice(len(u) - TRAJ_STEPS, size=batch, replace=False)
    tgt = np.stack([u[s + TRAJ_EVERY * j]
                    for j in range(1, TRAJ_STEPS // TRAJ_EVERY + 1)])
    t_out = np.arange(TRAJ_STEPS // TRAJ_EVERY + 1) * TRAJ_EVERY * DT
    return u[s], tgt, t_out


def traj_gradient(device, state0, policy, case, route_flags=()):
    """One gradient of the window's MSE under ``policy`` through
    ``odeint_adjoint``: (loss, dL/dy0, dL/dtheta flat, the solver)."""
    import torch

    y0, tgt, t_out = case
    ode, ex, _ = build_trainer(device, state0, fused=True,
                               flags=TRAJ_POLICIES[policy] + list(route_flags))
    if ode.traj.kind != policy:
        raise AssertionError(f"{policy}: the solver took {ode.traj.kind}")
    y = torch.as_tensor(y0, dtype=torch.float32, device=device)
    y.requires_grad_(True)
    tg = torch.as_tensor(tgt, dtype=torch.float32, device=device)
    loss = torch.mean((ode.odeint_adjoint(y, t_out)[1:] - tg) ** 2)
    loss.backward()
    flat = torch.cat([p.grad.reshape(-1) for p in ex.parameters()])
    return loss.detach(), y.grad.detach(), flat.detach(), (ode, ex, y, tg)


def traj_timed(run, reps=3):
    """(best synchronized seconds of ``run`` over ``reps``, peak device
    bytes above the baseline before it)."""
    import torch

    best, peak = float("inf"), 0
    for _ in range(reps):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
    return best, peak


def traj_costs(n, c, w):
    """Forward-step evaluations after the original pass that each policy's
    plan costs, as (engine re-steps, stage recomputes in step_adj).
    revolve: optimal_cost(n, c) re-steps (the ADVANCE steps) and n
    recomputes (every REVERSE). CAMS: cams.validate_plan(...)["cost"] =
    ADVANCE steps + CAPTURE steps of the reverse + REVERSE recomputes, the
    REVERSE ones inside step_adj. checkpoint: every step once more, its
    stages kept. solution_only: n recomputes. store_all: none."""
    from pnode_tpu_torch import cams, revolve

    fwd, rev = cams.cams_plan(n, c, w)
    cost = cams.validate_plan(fwd, rev, n, c, w)["cost"]
    inner = sum(1 for op, _ in rev if op == cams.REVERSE)
    return {"store_all": (0, 0), "solution_only": (0, n),
            "checkpoint": (n, 0),
            "revolve": (revolve.optimal_cost(n, c), n),
            "cams": (cost - inner, inner)}


def replay_trace(device, ode, ex, y, names, n=10):
    """Device us per launch and launches per replayed step of the kernels
    in ``names``, from a profiler trace of ``n`` replayed steps: one step
    and one step_adj with aux=None (the revolve and CAMS REVERSE) at y."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    params = ode._get_params()
    stp = ode._stepper.prepare(0.0, y, params, dt0=DT)
    lam = torch.ones_like(y)

    def replay():
        with torch.no_grad():
            y1, _, _ = stp.step(0.0, DT, y, params)
            stp.step_adj(0.0, DT, y, params, None, lam)
        return y1

    replay()
    torch.cuda.synchronize()
    out = {}
    for _ in range(4):  # the profiler may drop a kernel: trace again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                replay()
            torch.cuda.synchronize()
        kernels, _ = device_kernels(prof.events())
        for label, part in names.items():
            us = [e.time_range.elapsed_us() for e in kernels
                  if part in e.name]
            if us:
                out[label] = (sum(us) / len(us), len(us) / n)
        if len(out) == len(names):
            break
    return out


def phase_traj_policies(device, u):
    """10(a): the trajectory policies on the KS per-step kernel path."""
    import torch

    from pnode_tpu_torch import cams, revolve
    from pnode_tpu_torch.models import KSFuncEX
    from pnode_tpu_torch.ops.fused_ark_adjoint import fused_ark_step_adj
    from pnode_tpu_torch.ops.fused_ark_forward import fused_ark_step_fwd
    from pnode_tpu_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_fwd

    if not (revolve.using_native() and cams.using_native()):
        raise AssertionError("the checkpoint planners built from csrc/ did "
                             "not load")
    init = KSFuncEX(nx=NX, hidden=HIDDEN, use_fused=True, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
    state0 = {k: v.detach().clone() for k, v in init.state_dict().items()}
    case = traj_case(u)
    n, c = TRAJ_STEPS, TRAJ_CPS
    w = cams.stage_weight(4 * BATCH * NX, BATCH * NX)  # ARK3's 4 stages
    costs = traj_costs(n, c, w)
    log(f"[traj] KS IMEX B {BATCH}, MLP {NX} -> {HIDDEN} x4 -> {NX}, seed-0 "
        f"weights, {n} steps of dt {DT}, outputs every {TRAJ_EVERY}th step; "
        f"c {c}, CAMS stage weight {w} state units")
    wrappers = {"fused_mlp_fwd": fused_mlp_fwd, "fused_mlp_bwd": fused_mlp_bwd,
                "fused_ark_step_fwd": fused_ark_step_fwd,
                "fused_ark_step_adj": fused_ark_step_adj}
    for wr in wrappers.values():
        wr.launches = 0
    results, ref, readings = {}, None, {}
    routes = (("kernels", ()), ("generic", ("-pnode_fused_ark_adjoint", "off")))
    for route, flags in routes:
        for policy in TRAJ_POLICIES:
            with StepCounter() as cnt:
                loss, gy, gp, (ode, ex, y, tg) = traj_gradient(
                    device, state0, policy, case, flags)
            results[(route, policy)] = (loss, gy, gp)
            got = (cnt.steps - n, cnt.inner)
            if got != costs[policy]:
                raise AssertionError(
                    f"{route} {policy}: {got} re-steps and stage recomputes "
                    f"after the original pass, the plan costs "
                    f"{costs[policy]}")
            if route != "kernels":
                continue

            def run(ode=ode, ex=ex, y=y, tg=tg):
                for p in ex.parameters():
                    p.grad = None
                y.grad = None
                torch.mean((ode.odeint_adjoint(y, case[2])[1:] - tg)
                           ** 2).backward()

            secs, peak = traj_timed(run)
            readings[policy] = {"s": secs, "peak_mib": peak / 2**20,
                                "resteps": got[0], "recomputes": got[1]}
    counts = {k: wr.launches for k, wr in wrappers.items()}
    for route, _ in routes:
        ref = results[(route, "store_all")]
        for policy in TRAJ_POLICIES:
            loss, gy, gp = results[(route, policy)]
            same = (torch.equal(loss, ref[0]) and torch.equal(gy, ref[1])
                    and torch.equal(gp, ref[2]))
            log(f"[traj] {route} {policy}: loss {float(loss):.9e}, dL/dy0 "
                f"and dL/dtheta {'bitwise' if same else 'NOT bitwise'} "
                f"store_all's (rel {norm_err(gy, ref[1]):.3e}, "
                f"{norm_err(gp, ref[2]):.3e}); re-steps and stage "
                f"recomputes {costs[policy]}")
            if not same:
                raise AssertionError(f"{route} {policy}: the gradient is "
                                     "not store_all's bit for bit")
            if not bool(torch.isfinite(loss)):
                raise AssertionError(f"{policy}: non-finite loss")
    # the reverse's own transient (K3's per-block partials, the gradient):
    # the peak of one replayed step, which every policy pays
    ode, ex, _ = build_trainer(device, state0, fused=True)
    y0 = torch.as_tensor(case[0], dtype=torch.float32, device=device)
    params = ode._get_params()
    stp = ode._stepper.prepare(0.0, y0, params, dt0=DT)
    with torch.no_grad():
        _, floor = traj_timed(lambda: stp.step_adj(
            0.0, DT, stp.step(0.0, DT, y0, params)[0], params, None,
            torch.ones_like(y0)), reps=1)
    floor /= 2**20
    base = readings["store_all"]
    for policy, r in readings.items():
        r["trajectory_mib"] = r["peak_mib"] - floor
        log(f"[traj] kernels {policy}: {r['s'] * 1e3:.3f} ms per gradient "
            f"(best of 3, {r['s'] / base['s']:.3f}x store_all's), peak "
            f"{r['peak_mib']:.3f} MiB above the pre-solve baseline "
            f"({r['peak_mib'] / base['peak_mib']:.3f}x; "
            f"{r['trajectory_mib']:.3f} MiB above one replayed step's "
            f"{floor:.3f}), forward steps {n} + {r['resteps']} re-steps + "
            f"{r['recomputes']} stage recomputes")
    for policy in ("revolve", "cams"):
        if not readings[policy]["peak_mib"] < 0.5 * base["peak_mib"]:
            raise AssertionError(f"{policy}'s peak is not below half of "
                                 "store_all's")
    log(f"[traj] launches over (a): {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError("K1, K2 or K3 was never launched on the "
                             "trajectory policies' path")
    # one replayed step (the revolve/CAMS REVERSE: a re-step, then step_adj
    # recomputing its stages) traced on each route
    trace = {}
    for route, flags, names in (
            ("kernels", (), {"K2": "ark_fwd_kernel", "K3": "ark_adj_kernel",
                             "K3 sum": "sum_partials_kernel"}),
            ("generic", ("-pnode_fused_ark_adjoint", "off"),
             {"K1 fwd": "mlp_fwd_layer_kernel",
              "K1 bwd": "mlp_bwd_layer_kernel"})):
        ode, ex, _ = build_trainer(device, state0, fused=True,
                                   flags=TRAJ_POLICIES["revolve"]
                                   + list(flags))
        trace.update(replay_trace(device, ode, ex, y0, names))
    log("[traj] one replayed step traced (device us per launch x launches "
        "per step): " + ", ".join(f"{k} {us:.2f} x{per:.1f}"
                                  for k, (us, per) in trace.items()))
    # K1's device time per call at the KS stack (B 256), the generic
    # route's f_EX: 5 layer launches forward; 4 recomputes and 5 layer
    # launches backward
    spec = ex.fused_mlp_spec(dict(ex.named_parameters()))
    g = torch.ones_like(y0)
    k1 = {}
    for name, fn, parts, per in (
            ("fused_mlp_fwd",
             lambda: fused_mlp_fwd(y0, spec["Ws"], spec["bs"]),
             ["mlp_fwd_layer_kernel"], [5]),
            ("fused_mlp_bwd",
             lambda: fused_mlp_bwd(y0, g, spec["Ws"], spec["bs"]),
             ["mlp_fwd_layer_kernel", "mlp_bwd_layer_kernel"], [4, 5])):
        us, traced = device_us_per_call(fn, parts, per_call=per)
        k1[name] = us / 1e3
        log(f"[traj] {name} at B {BATCH}, {NX} -> {HIDDEN} x4 -> {NX}: "
            f"device {us:.2f} us per call ({traced} launches traced)")
    return counts, readings, trace, k1


DRIVER_RUN = (
    "import json, sys, importlib.util as u\n"
    "sys.path.insert(0, {root!r})\n"
    "s = u.spec_from_file_location({name!r}, {path!r})\n"
    "m = u.module_from_spec(s); s.loader.exec_module(m)\n"
    "print('RESULT ' + json.dumps(m.main({argv!r})))\n")


def start_driver(name, argv, cpu=False):
    """examples/<name>.py's main(argv) in a subprocess; its result comes
    back as the JSON line after RESULT."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    if cpu:
        env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    code = DRIVER_RUN.format(root=ROOT, name=name, argv=list(argv),
                             path=os.path.join(ROOT, "examples", f"{name}.py"))
    return (name, argv), subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)


def finish_driver(run, timeout=600):
    (name, argv), proc = run
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{name} {' '.join(argv)} timed out")
    if proc.returncode != 0:
        raise AssertionError(f"{name} {' '.join(argv)} failed "
                             f"({proc.returncode}):\n{out[-2000:]}\n"
                             f"{err[-3000:]}")
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


DRIVERS = {
    "spiral_torch": ["--niters", "40", "--test_freq", "20"],
    "spiral_unstable_torch": ["--niters", "12"],  # ~4 s an iteration
    "rober_torch": ["--niters", "20", "--test_freq", "10"],
}
DRIVER_TOL = 1e-4  # first loss, card fp32 against CPU fp64


def start_drivers():
    """10(b), started: the three drivers on the card at their defaults but
    the short run, and each one's first iteration on the CPU in fp64."""
    runs = {}
    for name, argv in DRIVERS.items():
        train_dir = ["--train_dir", os.path.join(ROOT, "build", name)]
        if name == "spiral_unstable_torch":
            train_dir = []
        runs[name] = start_driver(name, argv + train_dir)
        runs[name + " cpu"] = start_driver(
            name, ["--device", "cpu", "--double_prec", "--niters", "1"]
            + ([] if not train_dir else
               ["--train_dir", train_dir[1] + "_cpu"]), cpu=True)
    return runs


def check_drivers(res):
    """10(b), read: each loss falls, each first loss within DRIVER_TOL of
    the CPU fp64 run's (``res``: each run's result)."""
    first = {"spiral_torch": lambda o: o["losses"],
             "spiral_unstable_torch": lambda o: o["pnode"],
             "rober_torch": lambda o: o["losses"]}
    report = {}
    for name, argv in DRIVERS.items():
        out, cpu = res[name], res[name + " cpu"]
        losses = first[name](out)
        e_first = abs(losses[0] - first[name](cpu)[0]) / abs(
            first[name](cpu)[0])
        k = max(1, len(losses) // 4)
        falls = [np.mean(losses[-k:]) < np.mean(losses[:k])]
        if name == "spiral_unstable_torch":
            e_ref = abs(out["ref"][0] - cpu["ref"][0]) / abs(cpu["ref"][0])
            e_first = max(e_first, e_ref)
            falls.append(np.mean(out["ref"][-k:]) < np.mean(out["ref"][:k]))
        n_it = len(losses)
        report[name] = {"s_per_iter": out["seconds"] / n_it,
                        "first": losses[0], "e_first": e_first}
        log(f"[drivers] (b) {name} {' '.join(argv)}: losses "
            f"{losses[0]:.6e} -> {losses[-1]:.6e} (mean of the first {k} "
            f"{np.mean(losses[:k]):.6e}, of the last {k} "
            f"{np.mean(losses[-k:]):.6e}); first loss against the CPU fp64 "
            f"run {e_first:.3e} relative (tol {DRIVER_TOL}); "
            f"{out['seconds'] / n_it:.3f} s per iteration")
        if not (np.all(np.isfinite(losses)) and all(falls)
                and e_first <= DRIVER_TOL):
            raise AssertionError(f"{name} failed its checks")
    return report


def start_rober_hotstart(n_more=3):
    """10(b), started: rober_torch.py --hotstart for n_more iterations
    after its best checkpoint's, and one with another normalization."""
    from pnode_tpu_torch.utils import load_checkpoint

    name = "rober_torch"
    train_dir = os.path.join(ROOT, "build", name)
    ck = load_checkpoint(os.path.join(train_dir, "best.ckpt"))
    niters = int(ck["iter"]) + 1 + n_more
    run = start_driver(name, ["--niters", str(niters), "--test_freq", "10",
                              "--hotstart", "--train_dir", train_dir])
    bad = start_driver(name, ["--niters", str(niters + 1), "--hotstart",
                              "--normalize", "mean", "--train_dir",
                              train_dir])[1]
    return ck, niters, run, bad


def finish_rober_hotstart(ck, niters, run, bad):
    """10(b), read: the resumed run starts after the checkpoint's
    iteration; the other normalization is refused."""
    out = finish_driver(run)
    log(f"[drivers] (b) rober_torch --hotstart: the checkpoint of iteration "
        f"{ck['iter']} (loss {ck['best_loss']:.6e}); resumed at "
        f"{out['start']}, {len(out['losses'])} iterations, losses "
        + ", ".join(f"{x:.6e}" for x in out["losses"]))
    if not (out["start"] == ck["iter"] + 1
            and len(out["losses"]) == niters - out["start"]
            and np.all(np.isfinite(out["losses"]))):
        raise AssertionError("rober_torch --hotstart did not resume")
    _, err = bad.communicate(timeout=300)
    if bad.returncode == 0 or "normalization mismatch" not in err:
        raise AssertionError("rober_torch --hotstart took a checkpoint of "
                             "another normalization")


def fix_first_batch(mod):
    """Every minibatch the trainer draws is its first one (its batch
    function wrapped), so the losses of a few iterations show the
    optimizer's progress rather than the batches' spread."""
    draw = mod.make_batches

    def first_only(*a):
        batches = list(draw(*a))
        return batches[:1] * len(batches)

    mod.make_batches = first_only


DEFAULT_RUNS = {
    "ks_torch": ["--max_epochs", "1", "--data_size", "700"],
    # ARK3 IMEX with Newton on GMRES, ~50 s an iteration on the card: one
    "burgers_torch": ["--batch_time", "2", "--epochs", "1",
                      "--iters_per_epoch", "1", "--n_ic", "20"],
}


def phase_default(device, name):
    """10(c): ``name`` (ks_torch.py or burgers_torch.py) at its new
    defaults (the reference's: snode / cn / petsc; ARK3 IMEX with Newton
    on GMRES), in this process: ks_torch for an epoch of 4 iterations on
    its first minibatch throughout (fix_first_batch), its losses finite
    and falling; burgers_torch for one iteration, its loss finite; the
    wall time, and the launches of K10/K11 (ks) and K1, K10, K11
    (burgers), each above 0."""
    import pnode_tpu_torch as pt
    from pnode_tpu_torch.ops.circular_stencil import (
        circular_stencil_bwd, circular_stencil_fwd)
    from pnode_tpu_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_fwd

    wrappers = (fused_mlp_fwd, fused_mlp_bwd, circular_stencil_fwd,
                circular_stencil_bwd)
    need = {"ks_torch": (circular_stencil_fwd, circular_stencil_bwd),
            "burgers_torch": wrappers}[name]
    mod = load_example(name)
    pt.clear_options()
    for wr in wrappers:
        wr.launches = 0
    argv = DEFAULT_RUNS[name] + ["--device", device, "--train_dir",
                                 os.path.join(ROOT, "build",
                                              name + "_defaults")]
    t0 = time.perf_counter()
    if name == "ks_torch":
        fix_first_batch(mod)
        losses = mod.main(argv)[1][0]
    else:
        losses = []
        mod.main(argv, history=losses)
    wall = time.perf_counter() - t0
    counts = {wr.__name__: wr.launches for wr in wrappers}
    args, _ = mod.parse_args(argv)
    log(f"[defaults] (c) {name} {' '.join(argv[:-2])} (linear_solver "
        f"{args.linear_solver}, fixed_jacobian {args.fixed_jacobian}"
        + (f", model {args.pnode_model}, method {args.pnode_method}"
           if name == "ks_torch" else f", method {args.method}")
        + f"): {len(losses)} iterations, losses "
        + ", ".join(f"{x:.6e}" for x in losses)
        + f"; {wall:.1f} s in all (data and validation included), "
        f"{wall / len(losses):.2f} s an iteration so counted; launches "
        f"{counts}")
    falls = name != "ks_torch" or (len(losses) >= 2
                                   and losses[-1] < losses[0])
    if not (len(losses) >= 1 and np.all(np.isfinite(losses)) and falls):
        raise AssertionError(f"{name} at its defaults: the loss was not "
                             "finite" + ("" if falls else " or did not fall"))
    if min(counts[wr.__name__] for wr in need) <= 0:
        raise AssertionError(f"{name} at its defaults did not launch its "
                             "kernels")
    return {"losses": list(losses), "wall_s": wall, "launches": counts}


def phase_slice5(device, u):
    """Phase 10: the trajectory policies (a), the new drivers (b) and the
    trainers at their new defaults (c). Returns the launches of phase
    10(a) and 10(c) by kernel."""
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[traj] phase 10 on {smi.splitlines()[0]}")
    traj_counts, _, trace, k1 = phase_traj_policies(device, u)
    # (b) runs beside (c): the drivers in subprocesses, rober's --hotstart
    # once its first run is done
    runs = start_drivers()
    defaults = {"ks_torch": phase_default(device, "ks_torch")}
    res = {"rober_torch": finish_driver(runs.pop("rober_torch"))}
    hot = start_rober_hotstart()
    defaults["burgers_torch"] = phase_default(device, "burgers_torch")
    res.update({k: finish_driver(r) for k, r in runs.items()})
    check_drivers(res)
    finish_rober_hotstart(*hot)
    log(f"[traj] phase 10 took {time.perf_counter() - t0:.1f} s")
    launches = {name: {"trajectory_policies": c}
                for name, c in traj_counts.items()}
    for run, d in defaults.items():
        for name, c in d["launches"].items():
            launches.setdefault(name, {})[f"{run}_defaults"] = c
    return launches, trace, k1


# -- phase 11: the adaptive path's policies, disk, bf16 storage and states ----

ADAPT_POLICY_FLAGS = ["-ts_adapt_type", "basic", "-ts_rtol", "1e-4",
                      "-ts_atol", "1e-4", "-ts_adapt_max_steps", "64"]
ADAPT_SLOTS, ADAPT_CPS, ADAPT_EVERY, DISK_CHUNK = 64, 4, 2, 16
DISK_DIR = os.path.join(ROOT, "build", "ts_trajectory")
BF16 = ["-pnode_trajectory_dtype", "bfloat16"]
ADAPT_POLICIES = {
    "store_all": [],
    "solution_only": ["-ts_trajectory_solution_only", "1"],
    "checkpoint": ["-ts_trajectory_max_cps_ram", str(ADAPT_CPS)],
    "revolve": ["-ts_trajectory_max_cps_ram", str(ADAPT_CPS),
                "-ts_trajectory_schedule", "revolve"],
    "cams": ["-ts_trajectory_max_cps_ram", str(ADAPT_CPS),
             "-ts_trajectory_schedule", "cams"],
    "disk": ["-ts_trajectory_type", "disk", "-ts_trajectory_dirname",
             DISK_DIR, "-pnode_disk_chunk", str(DISK_CHUNK)],
}


def adaptive_policy_case(u, batch=BATCH, seed=11):
    """(y0, targets (5, B, 64), output times 0, 0.4, ..., 2.0): a window of
    the KS data, the targets every ADAPT_EVERY-th data step."""
    rng = np.random.default_rng(seed)
    n = 5 * ADAPT_EVERY
    s = rng.choice(len(u) - n, size=batch, replace=False)
    tgt = np.stack([u[s + ADAPT_EVERY * j] for j in range(1, 6)])
    return u[s], tgt, np.arange(6) * ADAPT_EVERY * DT


def adaptive_policy_gradient(device, state0, policy, case, flags=()):
    """One gradient of the window's MSE through odeint_adjoint under the
    adaptive controller and ``policy``: (loss, dL/dy0, dL/dtheta flat,
    stats, (ode, ex, y, tg))."""
    import torch

    y0, tgt, t_out = case
    ode, ex, _ = build_trainer(
        device, state0, fused=True,
        flags=ADAPT_POLICY_FLAGS + ADAPT_POLICIES[policy] + list(flags))
    if ode.traj.kind != policy:
        raise AssertionError(f"{policy}: the solver took {ode.traj.kind}")
    y = torch.as_tensor(y0, dtype=torch.float32, device=device)
    y.requires_grad_(True)
    tg = torch.as_tensor(tgt, dtype=torch.float32, device=device)
    loss = torch.mean((ode.odeint_adjoint(y, t_out)[1:] - tg) ** 2)
    loss.backward()
    flat = torch.cat([p.grad.reshape(-1) for p in ex.parameters()])
    return (loss.detach(), y.grad.detach(), flat.detach(), ode.last_stats,
            (ode, ex, y, tg))


def gated_cams_cost(plan_rev, live):
    """(re-steps, stage recomputes) of CAMS's reverse plan over the trial
    slots when a rejected or unreached slot computes nothing: ADVANCE and
    CAPTURE step the live slots they pass, REVERSE recomputes a live
    slot's stages inside step_adj."""
    from pnode_tpu_torch import cams

    alive = lambda k: k < len(live) and live[k]  # noqa: E731
    resteps = inner = node = 0
    for op, k in plan_rev:
        if op == cams.RESTORE:
            node = k
        elif op == cams.ADVANCE:
            resteps += sum(1 for j in range(node, k) if alive(j))
            node = k
        elif op == cams.CAPTURE:
            resteps += alive(k)
            node = k + 1
        elif op == cams.REVERSE:
            inner += alive(k)
    return resteps, inner


def adaptive_costs(acc, c, w):
    """(re-steps, stage recomputes) after the forward's trials that each
    policy costs over the accepted trials (``acc``: the accept flag per
    trial): revolve plans over the n accepted trials; checkpoint steps each
    accepted trial once more; CAMS walks cams_plan(64 slots, c, w) gated;
    solution_only and disk recompute each accepted trial's stages."""
    from pnode_tpu_torch import cams, revolve

    n = int(sum(acc))
    _, rev = cams.cams_plan(ADAPT_SLOTS, c, w)
    return {"store_all": (0, 0), "solution_only": (0, n), "checkpoint": (n, 0),
            "revolve": (revolve.optimal_cost(n, c), n),
            "cams": gated_cams_cost(rev, acc), "disk": (0, n)}


def phase_adaptive_policies(device, u):
    """11(a) and (b): every trajectory policy under the adaptive controller
    on the KS kernel path (K2 with err, K2, K3) and the generic path (K1),
    bitwise store_all's; bf16-compressed storage within bf16 distance."""
    import shutil

    import torch

    from pnode_tpu_torch import cams
    from pnode_tpu_torch.models import KSFuncEX
    from pnode_tpu_torch.ops.fused_ark_adjoint import fused_ark_step_adj
    from pnode_tpu_torch.ops.fused_ark_forward import (
        fused_ark_step_fwd, fused_ark_step_fwd_embedded)
    from pnode_tpu_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_fwd

    init = KSFuncEX(nx=NX, hidden=HIDDEN, use_fused=True, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
    state0 = {k: v.detach().clone() for k, v in init.state_dict().items()}
    case = adaptive_policy_case(u)
    w = cams.stage_weight(4 * BATCH * NX, BATCH * NX)  # ARK3's 4 stages
    log(f"[adapt-traj] KS IMEX B {BATCH}, MLP {NX} -> {HIDDEN} x4 -> {NX}, "
        f"seed-0 weights, outputs at t = "
        f"{[round(float(x), 6) for x in case[2]]}, "
        f"rtol = atol = 1e-4, "
        f"{ADAPT_SLOTS} trial slots, c {ADAPT_CPS}, CAMS stage weight {w}, "
        f"disk chunk {DISK_CHUNK}")
    wrappers = {"fused_mlp_fwd": fused_mlp_fwd, "fused_mlp_bwd": fused_mlp_bwd,
                "fused_ark_step_fwd": fused_ark_step_fwd,
                "fused_ark_step_fwd_embedded": fused_ark_step_fwd_embedded,
                "fused_ark_step_adj": fused_ark_step_adj}
    for wr in wrappers.values():
        wr.launches = 0
    results, readings, costs = {}, {}, {}
    routes = (("kernels", ()), ("generic", ("-pnode_fused_ark_adjoint", "off")))
    for route, flags in routes:
        for policy in ADAPT_POLICIES:
            with StepCounter() as cnt:
                loss, gy, gp, st, (ode, ex, y, tg) = adaptive_policy_gradient(
                    device, state0, policy, case, flags)
            if not st.completed:
                raise AssertionError(f"{route} {policy}: the controller did "
                                     f"not reach t = 2.0 in {ADAPT_SLOTS} "
                                     "trials")
            if route not in costs:  # the accept flags, from one forward
                fn = ode._get_adaptive_fn(case[2], True)
                with torch.no_grad():
                    _, _, trials = fn.forward_for_test(y.detach(),
                                                       ode._get_params())
                costs[route] = adaptive_costs(trials.acc, ADAPT_CPS, w)
            results[(route, policy)] = (loss, gy, gp, st)
            got = (cnt.steps, cnt.inner)
            if got != costs[route][policy]:
                raise AssertionError(
                    f"{route} {policy}: {got} re-steps and stage recomputes "
                    f"after the trials, the plan costs "
                    f"{costs[route][policy]}")
            if route != "kernels":
                continue

            def run(ode=ode, ex=ex, y=y, tg=tg):
                for p in ex.parameters():
                    p.grad = None
                y.grad = None
                torch.mean((ode.odeint_adjoint(y, case[2])[1:] - tg)
                           ** 2).backward()

            secs, peak = traj_timed(run)
            readings[policy] = {"s": secs, "peak_mib": peak / 2**20,
                                "resteps": got[0], "recomputes": got[1]}
    counts = {k: wr.launches for k, wr in wrappers.items()}
    for route, _ in routes:
        ref = results[(route, "store_all")]
        st = ref[3]
        log(f"[adapt-traj] {route}: {st.accepted} accepted and {st.rejected} "
            f"rejected trials, dt_first {st.dt_first:.4e}")
        for policy in ADAPT_POLICIES:
            loss, gy, gp, _ = results[(route, policy)]
            same = (torch.equal(loss, ref[0]) and torch.equal(gy, ref[1])
                    and torch.equal(gp, ref[2]))
            log(f"[adapt-traj] {route} {policy}: loss {float(loss):.9e}, "
                f"dL/dy0 and dL/dtheta {'bitwise' if same else 'NOT bitwise'}"
                f" store_all's (rel {norm_err(gy, ref[1]):.3e}, "
                f"{norm_err(gp, ref[2]):.3e}); re-steps and stage recomputes "
                f"{costs[route][policy]}")
            if not same:
                raise AssertionError(f"{route} {policy}: the gradient is not "
                                     "store_all's bit for bit")
            if not bool(torch.isfinite(loss)):
                raise AssertionError(f"{policy}: non-finite loss")
    base = readings["store_all"]
    for policy, r in readings.items():
        log(f"[adapt-traj] kernels {policy}: {r['s'] * 1e3:.3f} ms per "
            f"gradient (best of 3, {r['s'] / base['s']:.3f}x store_all's), "
            f"peak {r['peak_mib']:.3f} MiB above the pre-solve baseline "
            f"({r['peak_mib'] / base['peak_mib']:.3f}x), {r['resteps']} "
            f"re-steps + {r['recomputes']} stage recomputes")
    log(f"[adapt-traj] launches over (a): {counts}")
    need = ("fused_ark_step_fwd_embedded", "fused_ark_step_fwd",
            "fused_ark_step_adj", "fused_mlp_fwd", "fused_mlp_bwd")
    if min(counts[k] for k in need) <= 0:
        raise AssertionError("K2 (with err or without), K3 or K1 was never "
                             "launched on the adaptive policies' path")
    if os.path.isdir(DISK_DIR) and os.listdir(DISK_DIR):
        raise AssertionError(f"the disk policy left {os.listdir(DISK_DIR)}")

    # (b) bf16-compressed storage on the kernel path
    exact = results[("kernels", "store_all")]
    for wr in wrappers.values():
        wr.launches = 0
    for policy in ("store_all", "solution_only", "revolve"):
        loss, gy, gp, _, (ode, ex, y, tg) = adaptive_policy_gradient(
            device, state0, policy, case, BF16)

        def run(ode=ode, ex=ex, y=y, tg=tg):
            for p in ex.parameters():
                p.grad = None
            y.grad = None
            torch.mean((ode.odeint_adjoint(y, case[2])[1:] - tg)
                       ** 2).backward()

        secs, peak = traj_timed(run)
        errs = (rel_err(loss, exact[0]), norm_err(gy, exact[1]),
                norm_err(gp, exact[2]))
        log(f"[adapt-traj] (b) {policy} with bf16 storage: loss rel "
            f"{errs[0]:.3e}, dL/dy0 {errs[1]:.3e}, dL/dtheta {errs[2]:.3e} "
            f"(norm-wise, against the exact store_all; tol 2e-2); "
            f"{secs * 1e3:.3f} ms per gradient, peak {peak / 2**20:.3f} MiB "
            f"(fp32 storage: {readings[policy]['peak_mib']:.3f})")
        if not max(errs) <= 2e-2:
            raise AssertionError(f"{policy} with bf16 storage is not within "
                                 "bf16 distance of the exact gradient")
    counts_b = {k: wr.launches for k, wr in wrappers.items()}
    log(f"[adapt-traj] launches over (b): {counts_b}")
    shutil.rmtree(DISK_DIR, ignore_errors=True)
    return {k: counts[k] + counts_b[k] for k in counts}


def max_leaf_diff(got, ref):
    """(max |got - ref| over every leaf, max |ref|): the reference's gate
    numbers."""
    num = max(abs_err(a, b) for a, b in zip(got, ref))
    den = max(float(b.detach().abs().max()) for b in ref)
    return num, den


def phase_disk_gates(device):
    """11(c): the reference's two disk gates (tools/hardware_smoke.py:427-
    505). The explicit disk driver against the in-memory adjoint: the KS
    IMEX model at B 16, nx 16, hidden 24 (kernels on) over 12 steps with an
    interior output, chunk 5; the adaptive dopri5 solve of the MLP alone
    (rtol 1e-3, atol 1e-5, 48 trial slots), chunk 16. Each: max grad diff
    < 1e-3 x the gradient's scale."""
    import shutil

    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.models import KSFuncEX, KSFuncIM

    Bd, dd = 16, 16
    gen = torch.Generator(device=device)
    im = KSFuncIM(nx=dd, device=device)
    ex = KSFuncEX(nx=dd, hidden=24, use_fused=True, device=device,
                  generator=gen.manual_seed(3))
    y8 = torch.randn(Bd, dd, device=device, generator=gen.manual_seed(4))
    params = dict(ex.named_parameters())
    gates = {}

    pt.clear_options()
    pt.init(["chip_smoke", "-snes_type", "ksponly", "-ts_trajectory_dirname",
             DISK_DIR])
    ode = pt.ODESolver()
    ode.setupTS(torch.zeros(Bd, dd, device=device), pt.TorchFunc(im),
                step_size=DT, method="imex", imex_form=True,
                implicit_form=True, func2=pt.TorchFunc(ex),
                linear_solver="hpddm", fixed_jacobian=True, batch_size=Bd)
    t8 = np.array([0.0, 1.2, 2.4])  # 12 steps, interior output forcing
    loss8 = lambda o: torch.mean(o[1:] ** 2)  # noqa: E731
    for p in ex.parameters():
        p.grad = None
    loss8(ode.odeint_adjoint(y8, t8)).backward()
    g_mem = [p.grad.clone() for p in ex.parameters()]
    dsk = ode.disk_trajectory_solver(t8, chunk=5)  # ragged chunks
    _, (_, g_dsk) = dsk.value_and_grad(loss8, y8, ode._get_params())
    dsk.close()
    gates["disk"] = max_leaf_diff(list(g_dsk[1].values()), g_mem)

    pt.clear_options()
    pt.init(["chip_smoke", "-ts_adapt_type", "basic", "-ts_rtol", "1e-3",
             "-ts_atol", "1e-5", "-ts_adapt_max_steps", "48",
             "-ts_trajectory_dirname", DISK_DIR])
    ode9 = pt.ODESolver()
    ode9.setupTS(torch.zeros(Bd, dd, device=device), pt.TorchFunc(ex),
                 step_size=0.05, method="dopri5")
    t9 = np.array([0.0, 0.5])
    loss9 = lambda o: torch.mean(o[-1] ** 2)  # noqa: E731
    for p in ex.parameters():
        p.grad = None
    loss9(ode9.odeint_adjoint(y8, t9)).backward()
    g_mem9 = [p.grad.clone() for p in ex.parameters()]
    dsk9 = ode9.disk_trajectory_solver(t9, chunk=16)
    _, (_, g_dsk9) = dsk9.value_and_grad(loss9, y8, params)
    dsk9.close()
    gates["adaptive disk"] = max_leaf_diff(list(g_dsk9.values()), g_mem9)
    shutil.rmtree(DISK_DIR, ignore_errors=True)
    for name, (num, den) in gates.items():
        log(f"[disk] (c) {name} trajectory adjoint vs in-memory: max grad "
            f"diff {num:.3e} on scale {den:.3e} (gate < 1e-3 x scale)")
        if not num < 1e-3 * max(den, 1e-6):
            raise AssertionError(f"the {name} gate failed")
    return gates


BF16_METHODS = {"rk4": 2e-2, "dopri5": 2e-2, "cn": 2e-2, "beuler": 2e-2}


def phase_bf16_state(device):
    """11(d): a bf16 state on the card, tests/test_bf16_state.py's shapes
    (4 x 8, y0 linspace(0.1, 1)): each method's dL/dw and the IMEX, frozen-
    Jacobian block-solver and adaptive cases against fp32 at that file's
    tolerances; the state stays bf16, the parameter gradients fp32."""
    import torch

    import pnode_tpu_torch as pt

    y32 = torch.linspace(0.1, 1.0, 32, device=device).reshape(4, 8)

    def run(dtype, setup, f_im, f_ex=None, w0=None, t_out=(1.0,), flags=()):
        pt.clear_options()
        pt.init(["chip_smoke"] + list(flags))
        y0 = y32.to(dtype)
        master = (torch.tensor(0.5 if f_ex is None else 0.8, device=device)
                  if w0 is None else w0.clone()).requires_grad_(True)
        ode = pt.ODESolver()
        if f_ex is None:
            ode.setupTS(y0, pt.Func(f_im, {"w": master.detach()}), **setup)
            params = {"w": master}
        else:
            ode.setupTS(y0, pt.Func(f_im, {}),
                        func2=pt.Func(f_ex, {"w": master.detach()}), **setup)
            params = ({}, {"w": master.to(dtype) if w0 is not None
                           else master})
        s, _ = ode.solve(y0, np.asarray(t_out), params=params)
        s[-1].float().sum().backward()
        return s.detach(), master.grad

    def tanh_w(t, y, p):
        return torch.tanh(y) * p["w"]

    cases = {m: (dict(step_size=0.25, method=m), tanh_w, None, None, (1.0,),
                 (), tol, 0.0) for m, tol in BF16_METHODS.items()}
    imex = dict(step_size=0.25, method="imex", imex_form=True,
                implicit_form=True)
    cases["imex"] = (imex, lambda t, y, p: -0.5 * y,
                     lambda t, y, p: torch.sin(y) * p["w"], None, (1.0,), (),
                     3e-2, 0.0)
    cases["frozen J block"] = (
        dict(imex, linear_solver="hpddm", fixed_jacobian=True, batch_size=4),
        lambda t, y, p: 40.0 * (torch.roll(y, 1, -1) - 2 * y
                                + torch.roll(y, -1, -1)),
        lambda t, y, p: torch.tanh(y @ p["w"].to(y.dtype)),
        0.3 * torch.eye(8, device=device), (0.5,), ("-snes_type", "ksponly"),
        5e-2, 5e-3)
    cases["adaptive dopri5"] = (
        dict(step_size=0.1, method="dopri5"), tanh_w, None, None, (0.0, 1.0),
        ("-ts_adapt_type", "basic", "-ts_rtol", "1e-2", "-ts_atol", "1e-2"),
        5e-2, 0.0)
    out = {}
    for name, (setup, f_im, f_ex, w0, t_out, flags, rtol, atol) in \
            cases.items():
        sol_b, g_b = run(torch.bfloat16, setup, f_im, f_ex, w0, t_out, flags)
        sol_f, g_f = run(torch.float32, setup, f_im, f_ex, w0, t_out, flags)
        err = rel_err(g_b, g_f)
        ok = (sol_b.dtype == torch.bfloat16 and g_b.dtype == torch.float32
              and bool(torch.isfinite(sol_b.float()).all())
              and torch.allclose(g_b.double(), g_f.double(), rtol=rtol,
                                 atol=atol))
        if name == "adaptive dopri5":
            ok = ok and torch.allclose(sol_b[-1].float(), sol_f[-1],
                                       rtol=3e-2, atol=3e-2)
        log(f"[bf16] (d) {name}: state {sol_b.dtype}, dL/dw {g_b.dtype}; "
            f"dL/dw bf16 against fp32: max |diff| / max |fp32| {err:.3e} "
            f"(gate: rtol {rtol}, atol {atol} elementwise)")
        if not ok:
            raise AssertionError(f"the bf16 state's {name} case disagrees "
                                 "with fp32")
        out[name] = err
    return out


DP_REVOLVE = ["-ts_trajectory_max_cps_ram", "3", "-ts_trajectory_schedule",
              "revolve"]


def dp_revolve_case(u, batch=BATCH, seed=13):
    """(y0, targets (2, B, 64), t_out [0, 1, 2]): a 10-step window of the
    KS data, the targets at steps 5 and 10."""
    rng = np.random.default_rng(seed)
    s = rng.choice(len(u) - 10, size=batch, replace=False)
    return u[s], np.stack([u[s + 5], u[s + 10]]), np.array([0.0, 1.0, 2.0])


def dp_revolve_grads(device, state, y0, tgt, t_out, mesh=None):
    """(loss, flat gradient, trajectory kind, K2/K3 launches) of the KS
    window's MSE under revolve c 3 on the kernel path, on the whole batch
    or (``mesh``) this rank's shard meaned over the mesh by
    dp_value_and_grad."""
    import torch

    from pnode_tpu_torch.ops.fused_ark_adjoint import fused_ark_step_adj
    from pnode_tpu_torch.ops.fused_ark_forward import fused_ark_step_fwd
    from pnode_tpu_torch.parallel import dp_value_and_grad, shard_batch

    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device=device)
    batch = (f32(y0), f32(tgt).transpose(0, 1))  # rows first, to shard
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    ode, ex, _ = build_trainer(device, {k: f32(v) for k, v in state.items()},
                               fused=True, flags=DP_REVOLVE,
                               batch=batch[0].shape[0])
    params = list(ex.parameters())

    def loss_fn(prm, b):
        pred = ode.odeint_adjoint(b[0], t_out)
        return torch.mean((pred[1:] - b[1].transpose(0, 1)) ** 2)

    fused_ark_step_fwd.launches = fused_ark_step_adj.launches = 0
    if mesh is None:
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
    else:
        loss, grads = dp_value_and_grad(loss_fn, mesh)(params, batch)
    flat = torch.cat([g.reshape(-1) for g in grads])
    return (float(loss), flat.cpu().numpy(), ode.traj.kind,
            (fused_ark_step_fwd.launches, fused_ark_step_adj.launches))


def dp_revolve_rank(device, state, y0, tgt, t_out):
    """One rank of 11(e): the flat mesh of every rank."""
    from pnode_tpu_torch.parallel import make_mesh

    return dp_revolve_grads(device, state, y0, tgt, t_out, make_mesh())


def phase_dp_revolve(device, u):
    """11(e): dp_value_and_grad under revolve checkpointing on a gloo group
    of 2 processes on the one card, each rank 128 rows of the B 256 window,
    against the single process on the whole batch: the loss within rtol
    1e-5 and the gradient within 1e-4 norm-wise, every rank on revolve and
    launching K2 and K3, the ranks' gradients bitwise equal."""
    import torch

    from pnode_tpu_torch.models import KSFuncEX
    from pnode_tpu_torch.parallel import run_ranks

    init = KSFuncEX(nx=NX, hidden=HIDDEN, use_fused=True, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
    state = {k: v.detach().cpu().numpy() for k, v in init.state_dict().items()}
    y0, tgt, t_out = dp_revolve_case(u)
    loss1, g1, kind1, launches1 = dp_revolve_grads(device, state, y0, tgt,
                                                   t_out)
    t0 = time.perf_counter()
    ranks = run_ranks(2, dp_revolve_rank, state, y0, tgt, t_out,
                      backend="gloo", device=device, timeout=300.0)
    wall = time.perf_counter() - t0
    errs = [(abs(r[0] - loss1) / abs(loss1),
             float(np.linalg.norm(r[1] - g1) / np.linalg.norm(g1)))
            for r in ranks]
    same = all(np.array_equal(r[1], ranks[0][1]) for r in ranks)
    log(f"[dp-revolve] (e) 2 gloo ranks on the one card ({wall:.1f} s with "
        f"the spawn), revolve c 3 over 10 steps: loss {ranks[0][0]:.9e} "
        f"against the single process's {loss1:.9e}; per rank (loss rel, "
        f"gradient rel) {errs}; ranks' gradients "
        f"{'bitwise equal' if same else 'DIFFERENT'}; kinds "
        f"{[r[2] for r in ranks]}; K2, K3 launches per rank "
        f"{[r[3] for r in ranks]} (single process {launches1})")
    ok = (same and kind1 == "revolve"
          and all(r[2] == "revolve" and min(r[3]) > 0 for r in ranks)
          and max(e[0] for e in errs) <= 1e-5
          and max(e[1] for e in errs) <= 1e-4)
    if not ok:
        raise AssertionError("DP under revolve disagrees with the single "
                             "process")
    return {"fused_ark_step_fwd": sum(r[3][0] for r in ranks),
            "fused_ark_step_adj": sum(r[3][1] for r in ranks)}


def phase_slice5b(device, u):
    """Phase 11: the adaptive path's policies (a), bf16 storage (b), the
    disk gates (c), bf16 states (d) and DP under revolve (e). Returns the
    launches over (a), (b) and (e) by kernel."""
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[adapt-traj] phase 11 on {smi.splitlines()[0]}")
    launches = phase_adaptive_policies(device, u)
    phase_disk_gates(device)
    phase_bf16_state(device)
    for k, c in phase_dp_revolve(device, u).items():
        launches[k] += c
    log(f"[adapt-traj] phase 11 took {time.perf_counter() - t0:.1f} s")
    return launches


# -- phase 12: bf16 CIFAR ------------------------------------------------------

# phase 12(a)'s gate: each bf16 instance of K6-K9 against its plain bf16
# version on the same inputs, max |kernel - plain| / max |plain| per output
# tensor: two bf16 epsilons (2^-8 each). Both round the same fp32 values to
# bf16 at the same points; their fp32 sums run in other orders, so a value
# within an fp32 ulp of a bf16 rounding boundary lands one bf16 ulp apart
# (~1e-5 of the elements), and the next layer carries that on. K7 recomputes
# the chain's forward itself, so it is held in two parts, each at this gate:
# its anchors z_l against the plain forward's, and its gradients against
# the plain layer backward on its own anchors (k7_anchored_plain). Against
# the free plain backward its distance is printed, not gated: there the two
# forwards part by a bf16 ulp at some elements, which moves the next
# layers' pre-activations by ~1e-2 there and flips a few ReLU decisions,
# each an O(1) change of one cotangent element (max relative 5e-2 to
# 1.7e-1, norm-wise up to 2.2e-2 at the stage shapes, PERF.md §6), and no
# reading sets a limit that such flips pass and a fault fails
BF16_TOL = 2.0 ** -6
# phase 12(b)'s model gates, the bf16 kernel path against the bf16 module
# path (PERF.md §6 says why): the loss, relative, and the cosine of the
# head's dense-layer gradient. The whole gradient's cosine is printed, not
# gated: at the random init the deep layers' gradients are dominated by
# rounding noise that the 20 ODE blocks' batch-stats norms amplify, in the
# JAX package as in the port (tests/torch_bf16_witness.py, on the CPU at
# width 0.25, B 16, whole-gradient cosines: JAX's own bf16 model against
# its fp32 model -0.04, the port's two bf16 paths 0.12, the port's fp32
# model against JAX's 0.98; the head's 0.81, 0.97 and 1.00). On the card
# (PERF.md §6): losses 4.7e-3 to 8.0e-3
# apart, head cosines 0.991 to 0.995, inside the limits by 2.5x and more
CIFAR_BF16_TOL = {"loss": 2e-2, "head_cos": 0.98}
# phase 12(b)'s gate on the backward through the ODE blocks: one block's
# solve (rk4, Nt 2, the discrete adjoint: K6/K7 or K8/K9 through the
# solver and the model's autograd wiring) on the kernel path against the
# module path, from the same bf16 input and cotangent; every parameter
# gradient but the conv biases (true value 0) and dx: each tensor's cosine
# at least ``cos`` and its norm ratio within ``ratio``. One block is as
# well conditioned as its five layers, unlike the whole net. Readings on
# the CPU (the plain versions, width 0.5, B 8-16): the two bf16 paths
# 0.9934 at the least, ratios 0.97-1.03; the lower-precision control, the
# bf16 module path against the fp32 one (printed beside it on the card),
# 0.9908 and ratios 0.92-1.37, the narrowest layer's dgamma the farthest;
# the planted faults of tests/test_torch_sqnxt_bf16.py fail it (least
# cosine 0.56 and -0.64, ratio 0.50). On the card at full width, B 128
# (PERF.md §6): the two bf16 paths 0.9951 at the least, ratios 1.017 to
# 1.054; the control 0.9804 at the least, ratios 0.93 to 1.03
BF16_BLOCK_TOL = {"cos": 0.98, "ratio": (0.8, 1.25)}


def check_bf16(name, got, plain, report, failed):
    """max |got - plain| / max |plain| over each pair of tensors, gated at
    BF16_TOL; the largest, and the largest absolute difference, go to
    ``report``; a failure is noted in ``failed`` (raised at the phase's
    end, after every value is printed)."""
    e = max(rel_err(a, b) for a, b in zip(got, plain))
    ea = max(abs_err(a, b) for a, b in zip(got, plain))
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), ea)
    report["max_rel_err"] = max(report.get("max_rel_err", 0.0), e)
    ok = e <= BF16_TOL
    log(f"[bf16]   {name}: max rel err vs plain bf16 {e:.3e} (tol 2^-6 = "
        f"{BF16_TOL:.3e}), max abs {ea:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(name)


def print_bf16_free(name, got, plain, report):
    """||got - plain|| / ||plain|| and max |got - plain| / max |plain| over
    each pair of tensors, printed (not gated: see BF16_TOL); the largest
    go to ``report``."""
    e = max(norm_err(a, b) for a, b in zip(got, plain))
    m = max(rel_err(a, b) for a, b in zip(got, plain))
    report["free_norm_err"] = max(report.get("free_norm_err", 0.0), e)
    report["free_max_rel_err"] = max(report.get("free_max_rel_err", 0.0), m)
    log(f"[bf16]   {name}, against the free plain backward (not gated): "
        f"norm-wise rel err {e:.3e}, max rel {m:.3e}")


def k7_anchored_plain(x, g, flat, meta):
    """K7's bf16 instance once more, keeping the anchors z_l its forward
    recompute wrote, and the plain layer backward chained over them: layer
    l's norm and ReLU decisions from the kernel's z_l, its input rebuilt
    from the kernel's z_(l-1) (norm_relu with the plain statistics), so
    the reference takes the kernel's forward. Returns ((dx, dflat) of K7,
    (dx, dflat) of the reference, K7's anchors)."""
    from pnode_tpu_torch.ops import fused_sqnxt as fs

    flats = [fs._layer(flat, li) for li in range(5)]
    dx, grads, zs = fs._launch_bwd("pnode_sqnxt_bwd", x, g, flats, meta,
                                   list(range(5)), anchors=True)
    zs = [z.view(meta.cdims[li + 1], meta.n_real) for li, z in enumerate(zs)]
    hs = [x] + [fs.norm_relu(zs[li], flats[li], meta, li)[0]
                for li in range(4)]
    masks = fs._tap_masks(meta, x.device)
    gg, dflat = g, [None] * len(flat)
    for li in range(4, -1, -1):
        gg, d = fs._layer_bwd(hs[li], gg, flats[li], meta, li, masks, None,
                              z=zs[li])
        dflat[4 * li: 4 * li + 4] = d
    return ((dx, tuple(t for lg in grads for t in lg)), (gg, tuple(dflat)),
            zs)


def check_bf16_bias(name, got, plain, dbet, failed):
    """Conv-bias gradients in bf16: their true value is 0 (the bias feeds a
    batch-stats norm), so both versions return the sum of the rounding of
    g_z to bf16; gated in absolute terms at BF16_TOL of the largest
    |d_beta| of the same layers."""
    ea = max(abs_err(a, b) for a, b in zip(got, plain))
    ok = ea <= BF16_TOL * dbet
    log(f"[bf16]   {name} conv-bias gradients: max |kernel - plain| "
        f"{ea:.3e}, max |kernel| {max(float(t.abs().max()) for t in got):.3e}"
        f", against 2^-6 x max |d_beta| {dbet:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(name + " bias")


def bf16_case_inputs(label, h, mod, device, seed):
    """(x, flat, meta, gen, layered) of a phase 12(a) case: the bf16
    activation h (NCHW) on the (C, N) layout, the ODEDynamics mod's
    parameters (fp32, cast to bf16 as pack_params does), a generator from
    ``seed``, and whether the bf16 model runs this shape layered."""
    import torch

    from pnode_tpu_torch.ops import fused_sqnxt as fs

    bf = torch.bfloat16
    B, C, H, W = h.shape
    meta = fs.make_meta(C, B, H, W)
    x = h.permute(1, 0, 2, 3).reshape(C, -1).contiguous().to(bf)
    flat = [t.detach().contiguous() for t in
            fs.pack_params(dict(mod.named_parameters()), meta, bf)]
    layered = fs.gate_meta(C, B, H, W, bf).layered
    log(f"[bf16] {label}: C {C}, N {x.shape[1]} (B {B}, {H}x{W}), chain "
        f"workspace {fs.chain_workspace_bytes(meta, 2) / 2**20:.1f} MiB "
        f"({'layered' if layered else 'chain'} on the bf16 model)")
    return (x, flat, meta, torch.Generator(device=device).manual_seed(seed),
            layered)


def sqnxt_bf16_case(label, h, mod, device, seed, reports, failed):
    """The bf16 instances of K6-K9 against their plain bf16 versions on the
    bf16 activation h (NCHW) and the ODEDynamics mod: outputs, dx and every
    parameter gradient (check_bf16; conv biases by check_bf16_bias), each
    kernel called twice bitwise equal. K8/K9 as check_bf16_layers."""
    import torch

    from pnode_tpu_torch.ops import fused_sqnxt as fs

    bf = torch.bfloat16
    x, flat, meta, gen, _ = bf16_case_inputs(label, h, mod, device, seed)
    g = torch.randn(x.shape[0], x.shape[1], generator=gen,
                    device=device).to(bf)
    out = fs.fused_sqnxt_fwd(x, flat, meta)
    torch.cuda.synchronize()
    check_repeat("fused_sqnxt_fwd_bf16", out,
                 fs.fused_sqnxt_fwd(x, flat, meta))
    check_bf16("fused_sqnxt_fwd_bf16 out", [out],
               [fs.fused_sqnxt_plain(x, flat, meta)],
               reports["fused_sqnxt_fwd_bf16"], failed)
    is_b = lambda i: i % 4 == 1  # noqa: E731  the conv biases of flat

    def split(r):
        return ([r[0]] + [t for i, t in enumerate(r[1]) if not is_b(i)],
                [t for i, t in enumerate(r[1]) if is_b(i)])

    first = fs.fused_sqnxt_bwd(x, g, flat, meta)
    torch.cuda.synchronize()
    check_repeat("fused_sqnxt_bwd_bf16", first,
                 fs.fused_sqnxt_bwd(x, g, flat, meta))
    got, pl = split(first), split(fs.fused_sqnxt_bwd_plain(x, g, flat, meta))
    raw_k7, raw_ref, zs = k7_anchored_plain(x, g, flat, meta)
    check_repeat("fused_sqnxt_bwd_bf16 (anchors kept)", first, raw_k7)
    k7, anchored = split(raw_k7), split(raw_ref)
    masks, hh, z_plain = fs._tap_masks(meta, x.device), x, []
    for li in range(5):
        hh, zf, _, _ = fs._layer_fwd(hh, fs._layer(flat, li), meta, li,
                                     masks, None)
        z_plain.append(zf)
    check_bf16("fused_sqnxt_bwd_bf16 anchors z_1..z_5", zs, z_plain,
               {}, failed)
    check_bf16("fused_sqnxt_bwd_bf16 dx, on its own anchors", k7[0][:1],
               anchored[0][:1], reports["fused_sqnxt_bwd_bf16"], failed)
    check_bf16("fused_sqnxt_bwd_bf16 dW, dgamma, dbeta, on its own anchors",
               k7[0][1:], anchored[0][1:], reports["fused_sqnxt_bwd_bf16"],
               failed)
    print_bf16_free("fused_sqnxt_bwd_bf16 dx", got[0][:1], pl[0][:1],
                    reports["fused_sqnxt_bwd_bf16"])
    print_bf16_free("fused_sqnxt_bwd_bf16 dW, dgamma, dbeta", got[0][1:],
                    pl[0][1:], reports["fused_sqnxt_bwd_bf16"])
    dbet = max(float(t.abs().max()) for i, t in enumerate(pl[0][1:])
               if i % 3 == 2)
    check_bf16_bias("fused_sqnxt_bwd_bf16", got[1], pl[1], dbet, failed)
    check_bf16_bias("fused_sqnxt_bwd_bf16 on its own anchors", k7[1],
                    anchored[1], dbet, failed)
    hs = check_bf16_layers(x, flat, meta, gen, reports, failed)
    return x, g, flat, meta, hs


def check_bf16_layers(x, flat, meta, gen, reports, failed):
    """The bf16 instances of K8 and K9 against their plain bf16 versions,
    layer by layer on the plain chain's layer inputs from x, each with a
    cotangent from ``gen``: outputs, dh and every parameter gradient
    (check_bf16; conv biases by check_bf16_bias), each kernel called twice
    bitwise equal. Returns the layer inputs."""
    import torch

    from pnode_tpu_torch.ops import fused_sqnxt as fs

    hs, hh = [], x
    for li in range(5):
        hs.append(hh)
        hh = fs.fused_sqnxt_layer_plain(hh, fs._layer(flat, li), meta, li)
    fk, fp, bk, bp, bias_k, bias_p, dbets = [], [], [], [], [], [], []
    for li in range(5):
        lf = fs._layer(flat, li)
        fk.append(fs.fused_sqnxt_layer_fwd(hs[li], lf, meta, li))
        check_repeat(f"fused_sqnxt_layer_fwd_bf16 layer {li}", fk[-1],
                     fs.fused_sqnxt_layer_fwd(hs[li], lf, meta, li))
        fp.append(fs.fused_sqnxt_layer_plain(hs[li], lf, meta, li))
        gl = torch.randn(meta.cdims[li + 1], x.shape[1], generator=gen,
                         device=x.device).to(torch.bfloat16)
        kern = fs.fused_sqnxt_layer_bwd(hs[li], gl, lf, meta, li)
        check_repeat(f"fused_sqnxt_layer_bwd_bf16 layer {li}", kern,
                     fs.fused_sqnxt_layer_bwd(hs[li], gl, lf, meta, li))
        plain = fs.fused_sqnxt_layer_bwd_plain(hs[li], gl, lf, meta, li)
        bk += [kern[0], kern[1][0], kern[1][2], kern[1][3]]
        bp += [plain[0], plain[1][0], plain[1][2], plain[1][3]]
        bias_k.append(kern[1][1])
        bias_p.append(plain[1][1])
        dbets.append(float(plain[1][3].abs().max()))
    torch.cuda.synchronize()
    check_bf16("fused_sqnxt_layer_fwd_bf16 (5 layers) out", fk, fp,
               reports["fused_sqnxt_layer_fwd_bf16"], failed)
    check_bf16("fused_sqnxt_layer_bwd_bf16 (5 layers) dh", bk[0::4],
               bp[0::4], reports["fused_sqnxt_layer_bwd_bf16"], failed)
    check_bf16("fused_sqnxt_layer_bwd_bf16 (5 layers) dW, dgamma, dbeta",
               [t for i, t in enumerate(bk) if i % 4],
               [t for i, t in enumerate(bp) if i % 4],
               reports["fused_sqnxt_layer_bwd_bf16"], failed)
    check_bf16_bias("fused_sqnxt_layer_bwd_bf16", bias_k, bias_p,
                    max(dbets), failed)
    return hs


def time_sqnxt_bf16(label, h, mod, x, g, flat, meta, hs):
    """Per evaluation, in turns: each bf16 instance of K6-K9 beside its
    plain bf16 version, its fp32 instance on the same values in fp32, and
    the bf16 module path (F.conv2d in bf16 + BatchStatsNorm + ReLU; its
    backward by autograd); the profiler's device time of the bf16
    instance. Bounds at 2-byte storage."""
    import torch

    from pnode_tpu_torch.ops import fused_sqnxt as fs

    f32 = torch.float32
    x32, g32 = x.to(f32), g.to(f32)
    flat32 = [t.to(f32) for t in flat]
    hs32 = [t.to(f32) for t in hs]
    hg = h.detach().clone().requires_grad_(True)
    B, H, W = h.shape[0], h.shape[2], h.shape[3]
    g_nchw = g.reshape(meta.cdims[5], B, H, W).permute(1, 0, 2, 3)
    g_nchw = g_nchw.contiguous()
    params = list(mod.parameters())
    gls = [g[:meta.cdims[li + 1]].contiguous() for li in range(5)]
    gls32 = [t.to(f32) for t in gls]

    def module_fwd():
        with torch.no_grad():
            mod(0.0, h)

    def module_bwd():
        torch.autograd.grad(mod(0.0, hg), [hg] + params, g_nchw)

    def layers(fn, inp, fl):
        return lambda: [fn(inp[li], fs._layer(fl, li), meta, li)
                        for li in range(5)]

    def layers_bwd(fn, inp, gg, fl):
        return lambda: [fn(inp[li], gg[li], fs._layer(fl, li), meta, li)
                        for li in range(5)]

    chain = range(5)
    rows = {
        "fused_sqnxt_fwd_bf16": (
            lambda: fs.fused_sqnxt_fwd(x, flat, meta),
            lambda: fs.fused_sqnxt_plain(x, flat, meta),
            lambda: fs.fused_sqnxt_fwd(x32, flat32, meta), module_fwd,
            fs.sqnxt_cost(meta, chain, False, 2), 1, "sqnxt_fwd_kernel"),
        "fused_sqnxt_bwd_bf16": (
            lambda: fs.fused_sqnxt_bwd(x, g, flat, meta),
            lambda: fs.fused_sqnxt_bwd_plain(x, g, flat, meta),
            lambda: fs.fused_sqnxt_bwd(x32, g32, flat32, meta), module_bwd,
            fs.sqnxt_cost(meta, chain, True, 2), 1, "sqnxt_bwd_kernel"),
        "fused_sqnxt_layer_fwd_bf16": (
            layers(fs.fused_sqnxt_layer_fwd, hs, flat),
            layers(fs.fused_sqnxt_layer_plain, hs, flat),
            layers(fs.fused_sqnxt_layer_fwd, hs32, flat32), module_fwd,
            fs.sqnxt_layered_cost(meta, False, 2), 5, "sqnxt_fwd_kernel"),
        "fused_sqnxt_layer_bwd_bf16": (
            layers_bwd(fs.fused_sqnxt_layer_bwd, hs, gls, flat),
            layers_bwd(fs.fused_sqnxt_layer_bwd_plain, hs, gls, flat),
            layers_bwd(fs.fused_sqnxt_layer_bwd, hs32, gls32, flat32),
            module_bwd, fs.sqnxt_layered_cost(meta, True, 2), 5,
            "sqnxt_bwd_kernel"),
    }
    out = {}
    for name, (kern, plain, k32, module, (flops, byts), per_call,
               kname) in rows.items():
        t = [summary(cuda_times_ms(f, reps=10, warmup=2, inner=5))[0]
             for f in (plain, kern, k32, module, module, k32, kern, plain)]
        b_ms, b_by = bound(flops, byts, torch.bfloat16)
        us, traced = device_us_per_call(kern, [kname], per_call=[per_call])
        # the profiler may drop every launch of its traces: then single
        # calls between CUDA events, labelled so
        src = "profiler"
        dev_ms = us / 1e3
        if not traced:
            src = "CUDA events around single calls"
            dev_ms = single_call_ms(kern)
        out[name] = dict(ms=min(t[1], t[6]), plain_ms=min(t[0], t[7]),
                         fp32_ms=min(t[2], t[5]), module_ms=min(t[3], t[4]),
                         bound_ms=b_ms, bound_by=b_by, device_ms=dev_ms,
                         device_source=src)
        log(f"[bf16]   {label} {name} per evaluation: kernel {t[1]:.4f} / "
            f"{t[6]:.4f} ms, device {dev_ms:.4f} ms ({src}: {traced} "
            f"launches traced), fp32 instance {t[2]:.4f} / {t[5]:.4f} ms, "
            f"plain bf16 "
            f"{t[0]:.4f} / {t[7]:.4f} ms, bf16 module path {t[3]:.4f} / "
            f"{t[4]:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{flops / 1e9:.3f} GFLOP, {byts / 1e6:.2f} MB at 2-byte "
            f"storage); medians of 10 samples of 5 back-to-back calls")
    return out


def phase_sqnxt_bf16_kernels(device, x, x256):
    """Phase 12(a): the bf16 instances of K6-K9 at the three full-width
    stage shapes (B 128, on the bf16 model's own stage activations) and at
    every SQNXT_EDGES and SQNXT_BF16_EDGES case, against their plain bf16
    versions; timed at the stage shapes. K8 and K9 also at stage 1 on the
    images x256 (B 256: the bf16 model runs stage 1 layered there, as in
    12(d), each block holding twice B 128's z tiles in its store)."""
    import torch

    from pnode_tpu_torch.models.sqnxt import ODEDynamics, _lecun_normal_

    bf = torch.bfloat16
    model = cifar_model(device, "off", dtype="bf16")
    stages = stage_inputs(model, x)
    reports = {k + "_bf16": {} for k in SQNXT_KERNELS}
    timed, failed = {}, []
    for si, (h, mod) in enumerate(stages):
        label = f"stage {si + 1}"
        case = sqnxt_bf16_case(label, h, mod, device, 30 + si, reports,
                               failed)
        timed[label] = time_sqnxt_bf16(label, h, mod, *case)
    gen = torch.Generator().manual_seed(1)
    for k, (label, si, dim, B, H, W) in enumerate(SQNXT_EDGES +
                                                  SQNXT_BF16_EDGES):
        edge = ODEDynamics(dim, dtype=bf)
        for conv in edge.convs:
            w = conv.weight
            _lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], gen)
        edge = edge.to(device)
        h1 = stages[si][0]
        h1 = h1.repeat(-(-B // h1.shape[0]), 1, 1, 1)[:B, :dim, :H, :W]
        sqnxt_bf16_case(label, h1.contiguous(), edge, device, 40 + k,
                        reports, failed)
    h, mod = stage_inputs(model, x256)[0]
    x1, flat, meta, gen, layered = bf16_case_inputs(
        "stage 1, B 256: K8/K9", h, mod, device, 60)
    if not layered:
        failed.append("stage 1 at B 256 is not layered on the bf16 model")
    check_bf16_layers(x1, flat, meta, gen, reports, failed)
    if failed:
        raise AssertionError(f"bf16 K6-K9 disagree with their plain bf16 "
                             f"versions: {failed}")
    # the JSON line's times: stage 1, where the bf16 model runs the chain
    # (K6/K7) at B 128 and the layered mode (K8/K9) past B 186; stages 2
    # and 3 of K6/K7 beside them
    for name in reports:
        reports[name].update(timed["stage 1"][name])
    for name in ("fused_sqnxt_fwd_bf16", "fused_sqnxt_bwd_bf16"):
        reports[name]["stage2"] = timed["stage 2"][name]
        reports[name]["stage3"] = timed["stage 3"][name]
    return reports


def ode_block_grads(model, idx, h, g, layered=False):
    """One ODE block's gradient: the model's own solver for piece ``idx``
    (rk4, Nt 2, through the discrete adjoint; the kernel path on the (C, N)
    layout, in the layered mode where ``layered``) from the NCHW input h
    against the cotangent g of its output. Returns [dx, then every
    parameter gradient but the conv biases'], in fp64."""
    import torch

    from pnode_tpu_torch.ops import fused_sqnxt as fs

    mod = model.pieces[idx]
    hin = h.detach().clone().requires_grad_(True)
    params = dict(mod.named_parameters())
    B, C, H, W = h.shape
    if model.use_kernels:
        y0 = hin.permute(1, 0, 2, 3).reshape(C, -1).contiguous()
        meta = fs.gate_meta(mod.dim, B, H, W, dtype=h.dtype)
        ode = model._fused_solver(meta._replace(
            layered=meta.layered or layered), y0)
    else:
        y0 = hin
        ode = model._module_solver(mod, y0)
    sol, _ = ode.solve(y0, np.array([model.t1]), params=params,
                       with_adjoint=True)
    out = sol[-1]
    if model.use_kernels:
        out = out.reshape(C, B, H, W).permute(1, 0, 2, 3)
    keep = [p for k, p in params.items()
            if not (k.startswith("convs.") and k.endswith(".bias"))]
    grads = torch.autograd.grad(out, [hin] + keep, g.to(out.dtype))
    return [t.double() for t in grads]


def block_gate(got, ref):
    """(least cosine, norm ratio farthest from 1) over the pairs of
    tensors of ode_block_grads, and whether they pass BF16_BLOCK_TOL."""
    cos, ratio = 1.0, 1.0
    for a, b in zip(got, ref):
        a, b = a.reshape(-1), b.reshape(-1)
        cos = min(cos, float(a @ b / (a.norm() * b.norm())))
        r = float(a.norm() / b.norm())
        ratio = r if abs(r - 1) > abs(ratio - 1) else ratio
    lo, hi = BF16_BLOCK_TOL["ratio"]
    return cos, ratio, cos >= BF16_BLOCK_TOL["cos"] and lo <= ratio <= hi


def phase_bf16_blocks(m_on, m_off, m_32, x, seed=50):
    """Phase 12(b), the backward through the ODE blocks: at each stage's
    first ODE block, on the bf16 model's own stage activation and a random
    bf16 cotangent, the kernel path's block gradient against the module
    path's (block_gate, BF16_BLOCK_TOL); stage 1 also in the layered mode
    (K8/K9). Beside it the lower-precision control: the bf16 module path
    against the fp32 module path on the same input. Returns the failed
    cases."""
    import torch

    failed = []
    for si, (h, mod) in enumerate(stage_inputs(m_off, x)):
        idx = next(i for i, p in enumerate(m_off.pieces) if p is mod)
        gen = torch.Generator(device=h.device).manual_seed(seed + si)
        g = torch.randn(h.shape, generator=gen, device=h.device).to(h.dtype)
        ref = ode_block_grads(m_off, idx, h, g)
        ctl = block_gate(ref, ode_block_grads(m_32, idx, h.float(),
                                              g.float()))
        for layered in ((False, True) if si == 0 else (False,)):
            cos, ratio, ok = block_gate(
                ode_block_grads(m_on, idx, h, g, layered), ref)
            label = (f"stage {si + 1} block {idx}"
                     f"{' layered' if layered else ''}")
            log(f"[bf16] (b) {label}, input {tuple(h.shape)}: kernel path "
                f"vs module path, least cosine over dx and the parameter "
                f"gradients {cos:.6f} (tol {BF16_BLOCK_TOL['cos']}), norm "
                f"ratio {ratio:.6f} (tol {BF16_BLOCK_TOL['ratio']}); "
                f"control, bf16 vs fp32 module path: {ctl[0]:.6f}, "
                f"{ctl[1]:.6f} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(label)
    return failed


def phase_cifar_bf16_paths(device, x, y, state0):
    """Phase 12(b), the gates: the bf16 kernel path against the bf16
    module path from the same weights on one batch (loss and the head's
    gradient cosine, CIFAR_BF16_TOL; the whole gradient's cosine and norm
    ratio printed), the backward through the ODE blocks
    (phase_bf16_blocks), and the bf16 kernel path's predictions against the
    fp32 kernel path's (as tests/test_models.py: every image whose fp32
    top-2 margin exceeds twice the largest logit difference keeps its
    argmax; at the random init the bf16 and fp32 logits part by more than
    any image's margin, so this decides no image and the agreement is
    printed, not gated)."""
    import torch

    m_on = cifar_model(device, "on", state0, dtype="bf16")
    m_off = cifar_model(device, "off", state0, dtype="bf16")
    lo_on, l_on, g_on = grads_of(m_on, x, y)
    lo_off, l_off, g_off = grads_of(m_off, x, y)
    heads = [torch.cat([p.grad.reshape(-1).double()
                        for p in m.pieces[-1].dense.parameters()])
             for m in (m_on, m_off)]
    head_cos = float(heads[0] @ heads[1]
                     / (heads[0].norm() * heads[1].norm()))
    m_32 = cifar_model(device, "on", state0)
    with torch.no_grad():
        lo_32 = m_32(x, training=False)
        lo_bf = m_on(x, training=False)
    m_32.use_kernels = False  # the fp32 module path for the block control
    e_loss = abs(l_on - l_off) / abs(l_off)
    cos = float(g_on @ g_off / (g_on.norm() * g_off.norm()))
    ratio = float(g_on.norm() / g_off.norm())
    diff = float((lo_bf - lo_32).abs().max())
    top2 = lo_32.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * diff
    agree = lo_bf.argmax(-1) == lo_32.argmax(-1)
    ok = (e_loss <= CIFAR_BF16_TOL["loss"]
          and head_cos >= CIFAR_BF16_TOL["head_cos"]
          and bool(agree[sure].all()))
    log(f"[bf16] (b) bf16 kernel path vs bf16 module path, B {CIFAR_B}, "
        f"seed-0 weights: logits rel {rel_err(lo_on, lo_off):.3e}, loss "
        f"{l_on:.6f} vs {l_off:.6f} rel {e_loss:.3e} (tol "
        f"{CIFAR_BF16_TOL['loss']:.0e}), head gradient cosine "
        f"{head_cos:.6f} (tol {CIFAR_BF16_TOL['head_cos']}), whole gradient "
        f"cosine {cos:.6f}, norm ratio {ratio:.6f} (not gated); against "
        f"the fp32 kernel path: max |logit diff| {diff:.3e} of max |logit| "
        f"{float(lo_32.abs().max()):.3e}, argmax equal on "
        f"{int(agree.sum())} of {len(agree)} images (not gated), on all "
        f"{int(sure.sum())} whose fp32 margin exceeds 2x that "
        f"{'ok' if ok else 'FAIL'}")
    failed = phase_bf16_blocks(m_on, m_off, m_32, x)
    if not ok or failed:
        raise AssertionError(f"the bf16 CIFAR paths disagree: model "
                             f"{'ok' if ok else 'FAIL'}, blocks {failed}")


def profile_cifar_bf16_at(device, x_tr, y_tr, B, warm=2):
    """One traced iteration (profile_cifar) of a fresh bf16 kernel path at
    batch B, as train_cifar10_torch.py --precision bf16 --batch_size B
    trains (seed-0 weights, train_cifar's SGD), after ``warm`` untraced
    ones; the batches drawn from x_tr, y_tr with seed 0."""
    import torch

    rng = np.random.default_rng(0)
    idx = [torch.as_tensor(rng.choice(len(x_tr), B, replace=False),
                           device=device) for _ in range(warm + 1)]
    m = cifar_model(device, "on", dtype="bf16")
    opt = torch.optim.SGD(m.parameters(), lr=CIFAR_LR, momentum=0.9,
                          weight_decay=5e-4)
    for i in idx[:-1]:
        cifar_step(m, opt, x_tr[i], y_tr[i])
    profile_cifar(f"bf16 kernel path B {B}", m, opt, x_tr[idx[-1]],
                  y_tr[idx[-1]])


def phase_cifar_bf16(device, fp32_ips, n_iters=12, warm=2, n_trainer=2):
    """Phase 12: bf16 CIFAR at full width, batch 128, rk4, Nt 2.
    ``fp32_ips``: phase 6(c)'s fp32 kernel path's images/s over as many
    iterations after as many warm ones, which (c) reads beside the bf16
    kernel path's."""
    import torch

    from pnode_tpu_torch.ops import fused_sqnxt as fs

    cif = load_example("train_cifar10_torch")
    x_np, y_np, _, _, _ = cif.load_cifar10(
        os.path.join(ROOT, "data", "cifar-10-batches-py"))
    x_tr = torch.as_tensor(x_np, device=device)
    y_tr = torch.as_tensor(y_np, device=device).long()
    rng = np.random.default_rng(1)
    batches = [torch.as_tensor(rng.choice(len(x_np), CIFAR_B, replace=False),
                               device=device) for _ in range(n_iters)]
    reports = phase_sqnxt_bf16_kernels(device, x_tr[batches[0]],
                                       x_tr[torch.cat(batches[:2])])
    state0 = {k: v.detach().clone()
              for k, v in cifar_model(device, "off").state_dict().items()}
    phase_cifar_bf16_paths(device, x_tr[batches[0]], y_tr[batches[0]],
                           state0)
    wrappers = [fs.fused_sqnxt_fwd, fs.fused_sqnxt_bwd,
                fs.fused_sqnxt_layer_fwd, fs.fused_sqnxt_layer_bwd]
    # (c) images/s and peak memory: bf16 kernels, then bf16 module on the
    # first half of the same batches (the kernel path's losses alone are
    # gated); the bf16 kernel path's launches and one traced iteration.
    # The fp32 kernel path's images/s is phase 6(c)'s, over as many timed
    # iterations.
    for w in wrappers:
        w.launches_bf16 = 0
    runs = {}
    for label, uk in (("bf16 kernel path", "on"), ("bf16 module path",
                                                    "off")):
        m = cifar_model(device, uk, state0, dtype="bf16")
        n = n_iters if uk == "on" else n_iters // 2
        losses, ips, peak, opt = train_cifar(label, m, batches[:n], x_tr,
                                             y_tr, warm)
        runs[label] = (losses, ips, peak)
        if uk == "on":
            counts = {w.__name__ + "_bf16": w.launches_bf16
                      for w in wrappers}
            profile_cifar("bf16 kernel path", m, opt, x_tr[batches[0]],
                          y_tr[batches[0]])
    losses = runs["bf16 kernel path"][0]
    log(f"[bf16] (c) images/s: " + ", ".join(
        f"{k} {v[1]:.1f}" for k, v in runs.items()) + "; peak GB: " +
        ", ".join(f"{k} {v[2]:.3f}" for k, v in runs.items()))
    ratio = runs["bf16 kernel path"][1] / fp32_ips
    log(f"[bf16] (c) bf16 kernel path {runs['bf16 kernel path'][1]:.1f} "
        f"images/s against phase 6(c)'s fp32 kernel path {fp32_ips:.1f} "
        f"(each over iterations {warm}..{n_iters}): {ratio:.3f}x, "
        f"{'at least' if ratio >= 1.0 else 'below'} fp32's (not gated)")
    log(f"[bf16] (c) bf16 launches over the kernel path's {n_iters} "
        f"iterations at B {CIFAR_B} (chain at every stage): {counts}")
    if not (np.all(np.isfinite(losses)) and losses[-5:].mean()
            < losses[:5].mean()):
        raise AssertionError(f"bf16 CIFAR training did not lower the loss: "
                             f"{losses}")
    profile_cifar_bf16_at(device, x_tr, y_tr, 256)
    # (d) examples/train_cifar10_torch.py --precision bf16 at B 256, where
    # the bf16 gate runs stage 1 layered (K8/K9) and stages 2-3 chained
    # (K6/K7), then --use_kernels off
    before = {w.__name__: w.launches_bf16 for w in wrappers}
    for uk in ("on", "off"):
        t0 = time.perf_counter()
        acc = cif.main(["--precision", "bf16", "--use_kernels", uk,
                        "--batch_size", "256", "--epochs", "1",
                        "--iters_per_epoch", str(n_trainer), "--train_dir",
                        os.path.join(ROOT, "build", "cifar_bf16_" + uk)])
        log(f"[bf16] (d) train_cifar10_torch.py --precision bf16 "
            f"--use_kernels {uk} --batch_size 256, {n_trainer} iterations: "
            f"test accuracy {acc:.4f}, {time.perf_counter() - t0:.1f} s")
        if uk == "on":
            for w in wrappers:
                counts[w.__name__ + "_bf16"] += (w.launches_bf16
                                                 - before[w.__name__])
    memstat = open(os.path.join(ROOT, "build", "cifar_bf16_on",
                                "memstat.txt")).read().split()
    log(f"[bf16] (d) memstat.txt: {' '.join(memstat[-6:])}")
    if memstat[-1] != "bf16":
        raise AssertionError("memstat.txt does not carry the dtype")
    log(f"[bf16] bf16 launches over (c) and (d): {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the bf16 "
                                 "CIFAR path")
    return reports, counts


# -- phase 13: slice 10 --------------------------------------------------------

GATE_B = 128  # tools/hardware_smoke.py's batch


def ks_gate_model(device, state, dtype):
    """(ode, ex) of tools/hardware_smoke.py's KS setup at batch 128: ARK3
    IMEX at dt 0.2, hpddm with the frozen Jacobian, ksponly, f_EX on the
    fused MLP (K1, and on the card K2/K3 through the fused gate) in
    ``dtype``, the weights ``state``."""
    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.models import KSFuncEX, KSFuncIM

    pt.clear_options()
    pt.init(["chip_smoke", "-snes_type", "ksponly"])
    im = KSFuncIM(nx=NX, dtype=dtype, device=device)
    ex = KSFuncEX(nx=NX, hidden=HIDDEN, use_fused=True, dtype=dtype,
                  device=device)
    ex.load_state_dict({k: v.to(dtype) for k, v in state.items()})
    ode = pt.ODESolver()
    ode.setupTS(torch.zeros(GATE_B, NX, dtype=dtype, device=device),
                pt.TorchFunc(im), step_size=DT, method="imex",
                imex_form=True, func2=pt.TorchFunc(ex), linear_solver="hpddm",
                fixed_jacobian=True, batch_size=GATE_B)
    return ode, ex


def gate_gradient(device, state, y0, tgt, dtype):
    """(loss, flat gradient in fp64) of the one-step MSE through
    odeint_adjoint in ``dtype`` (hardware_smoke.py's gate 4)."""
    import torch

    ode, ex = ks_gate_model(device, state, dtype)
    pred = ode.odeint_adjoint(torch.as_tensor(y0, dtype=dtype, device=device),
                              np.array([0.0, DT]))
    loss = torch.mean((pred[-1] - torch.as_tensor(tgt, dtype=dtype,
                                                  device=device)) ** 2)
    loss.backward()
    return float(loss.detach()), torch.cat(
        [p.grad.reshape(-1).double().cpu() for p in ex.parameters()])


def phase_hardware_gates(device, u):
    """13, gates 1 and 4 of tools/hardware_smoke.py on the port: one ARK3
    IMEX step of the KS data (u[300:428] -> u[301:429]) on the kernel path,
    its MSE below 50x the identity's; the one-step MSE gradient by
    odeint_adjoint on the card in fp32 and on the CPU in fp64 from the
    same weights (drawn on the CPU), cosine above 0.99 (the reference's
    gate). Returns the K1-K3 launches of the card's runs."""
    import torch

    from pnode_tpu_torch.models import KSFuncEX
    from pnode_tpu_torch.ops.fused_ark_adjoint import fused_ark_step_adj
    from pnode_tpu_torch.ops.fused_ark_forward import fused_ark_step_fwd
    from pnode_tpu_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_fwd

    wrappers = {"fused_mlp_fwd": fused_mlp_fwd, "fused_mlp_bwd": fused_mlp_bwd,
                "fused_ark_step_fwd": fused_ark_step_fwd,
                "fused_ark_step_adj": fused_ark_step_adj}
    state = {k: v.detach().clone() for k, v in KSFuncEX(
        nx=NX, hidden=HIDDEN, use_fused=True,
        generator=torch.Generator().manual_seed(0)).state_dict().items()}
    y0, tgt = u[300:300 + GATE_B], u[301:301 + GATE_B]
    for w in wrappers.values():
        w.launches = 0
    ode, _ = ks_gate_model(device, state, torch.float32)
    with torch.no_grad():
        pred = ode.odeint(torch.as_tensor(y0, dtype=torch.float32,
                                          device=device), np.array([0.0, DT]))
    mse = float(torch.mean((pred[-1].cpu().double()
                            - torch.as_tensor(tgt)) ** 2))
    ident = float(np.mean((y0 - tgt) ** 2))
    ok1 = mse < 50 * max(ident, 1e-6)
    log(f"[slice10] gate 1, one-step MSE against the KS data (B {GATE_B}, "
        f"dt {DT}, ARK3 IMEX, hpddm, frozen J, ksponly): solver {mse:.6f}, "
        f"identity {ident:.6f} (bound 50x: {50 * ident:.4f}) "
        f"{'ok' if ok1 else 'FAIL'}")
    t0 = time.perf_counter()
    l_k, g_k = gate_gradient(device, state, y0, tgt, torch.float32)
    t_card = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    t0 = time.perf_counter()
    l_c, g_c = gate_gradient("cpu", state, y0, tgt, torch.float64)
    cos = float(g_k @ g_c / (g_k.norm() * g_c.norm()))
    ok4 = cos > 0.99
    log(f"[slice10] gate 4, the one-step MSE gradient by odeint_adjoint: "
        f"card fp32 (loss {l_k:.6e}, {t_card:.2f} s) against the port's CPU "
        f"fp64 run (loss {l_c:.6e}, {time.perf_counter() - t0:.2f} s): "
        f"cosine {cos:.8f} (tol > 0.99) {'ok' if ok4 else 'FAIL'}")
    log(f"[slice10] K1-K3 launches over gates 1 and 4 on the card: {counts}")
    if not (ok1 and ok4):
        raise AssertionError("hardware gate 1 or 4 failed")
    for k in ("fused_ark_step_fwd", "fused_ark_step_adj"):
        if counts[k] <= 0:
            raise AssertionError(f"{k} was never launched by gates 1 and 4")
    return counts


def phase_loader_and_hotstart(device, u):
    """13: WindowedLoader built from csrc/ on this machine and its batches;
    examples/ks_torch.py on the main path's flags for 2 epochs, then
    --hotstart to 3, which resumes after the best checkpoint's epoch (epoch
    2 where epoch 1 validated best) with its best validation loss; annotate's
    span in a trace()d step; the device's memory readings."""
    import torch

    from pnode_tpu_torch import native
    from pnode_tpu_torch.data import WindowedLoader
    from pnode_tpu_torch.utils import (
        annotate, device_memory_gb, load_checkpoint, trace)

    t0 = time.perf_counter()
    u32 = u[:480].astype(np.float32)
    ld = WindowedLoader(u32, window=1, batch=BATCH, seed=0)
    batches = list(ld)
    rows = {r.tobytes(): i for i, r in enumerate(u32)}
    ok = ld.native and len(batches) == 1 and all(
        np.array_equal(tgt[:, 0], u32[[rows[r.tobytes()] + 1 for r in y0]])
        for y0, tgt in batches)
    log(f"[slice10] WindowedLoader: native {ld.native} "
        f"({native.build('windowed_loader').name}), {len(batches)} batch of "
        f"{BATCH} per epoch from 480 states, targets the next state "
        f"{'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.2f} s with "
        f"the build)")
    ld.close()
    if not ok:
        raise AssertionError("WindowedLoader failed on the card's machine")
    ks = load_example("ks_torch")
    train_dir = os.path.join(ROOT, "build", "ks_hotstart")
    argv = ["--pnode_model", "imex", "--linear_solver", "hpddm",
            "--fixed_jacobian", "--data_size", "600", "--train_dir",
            train_dir]
    t0 = time.perf_counter()
    best1, hist1 = ks.main(argv + ["--max_epochs", "2"])
    ck1 = load_checkpoint(os.path.join(train_dir, "best_imex.ckpt"))
    best2, hist2 = ks.main(argv + ["--max_epochs", "3", "--hotstart"])
    ck2 = load_checkpoint(os.path.join(train_dir, "best_imex.ckpt"))
    start = int(ck1["epoch"]) + 1
    ok = (len(hist1) == 2 and len(hist2) == 3 - start
          and ck1["best_val"] == best1 and best2 <= best1
          and ck2["best_val"] == best2
          and int(ck2["epoch"]) in [ck1["epoch"]] + list(range(start, 3))
          and np.all(np.isfinite(sum(hist1 + hist2, []))))
    log(f"[slice10] ks_torch.py (imex, hpddm, frozen J) 2 epochs: best val "
        f"{best1:.6e} at epoch {ck1['epoch']}; --hotstart to 3: resumed at "
        f"epoch {start}, {len(hist2)} epochs of {len(hist2[0])} iterations, "
        f"best val {best2:.6e} (the checkpoint's epoch {ck2['epoch']}); "
        f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ks_torch.py --hotstart did not resume")
    ode, ex = ks_gate_model(device, {k: torch.as_tensor(v) for k, v in
                                     ck2["params"].items()}, torch.float32)
    logdir = os.path.join(ROOT, "build", "slice10_trace")
    with trace(logdir) as prof:
        with annotate("pnode-slice10-step"):
            loss_and_grads(ode, ex, u[300:300 + GATE_B],
                           u[301:301 + GATE_B], device)
            torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    text = open(os.path.join(logdir, "trace.json")).read()
    mem = device_memory_gb()
    ok = "pnode-slice10-step" in names and "pnode-slice10-step" in text \
        and mem["peak_gb"] > 0
    log(f"[slice10] trace(): annotate's span in the profiler's events and "
        f"in {logdir}/trace.json; device_memory_gb {mem} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("trace/annotate/device_memory_gb failed")


def phase_slice10(device, u):
    """Phase 13: slice 10 on the card. Returns the K1-K3 launches of the
    hardware gates."""
    t0 = time.perf_counter()
    counts = phase_hardware_gates(device, u)
    phase_loader_and_hotstart(device, u)
    log(f"[slice10] phase 13 took {time.perf_counter() - t0:.1f} s")
    return counts



# -- phase 14: FFJORD ---------------------------------------------------------

FFJORD_WARM = 3       # miniboone iterations before the timed ones
FFJORD_ITERS = 10     # timed miniboone iterations
FFJORD_COS = 0.9999   # card fp32 gradient against the CPU fp64 one
FFJORD_TRIP = 1e-4    # x -> z -> x (relative to max |x|) and delta_logp
GATE5_STEPS = 10      # tools/hardware_smoke.py's gate 5
FFJORD_DRIVERS = {    # (d): the image and toy drivers at their defaults
    "ffjord_image_torch": ["--epochs", "1", "--iters_per_epoch", "6",
                           "--n_sample", "4"],
    "ffjord_toy_torch": ["--niters", "12"],
}


def kernel_wrappers():
    """Every KERNELS entry's wrapper and the attribute that counts its
    launches (the bf16 instances count in ``launches_bf16``)."""
    import pnode_tpu_torch.ops.circular_stencil as cs
    import pnode_tpu_torch.ops.fused_adaptive_loop as fal
    import pnode_tpu_torch.ops.fused_ark_adjoint as faa
    import pnode_tpu_torch.ops.fused_ark_forward as faf
    import pnode_tpu_torch.ops.fused_mlp as fm
    import pnode_tpu_torch.ops.fused_sqnxt as fs
    import pnode_tpu_torch.ops.fused_train_loop as ftl
    from pnode_tpu_torch.tools import probe_smem_limit as probe

    out = {}
    for mod, names in ((fm, ("fused_mlp_fwd", "fused_mlp_bwd")),
                       (faf, ("fused_ark_step_fwd",
                              "fused_ark_step_fwd_embedded")),
                       (faa, ("fused_ark_step_adj",)),
                       (ftl, ("fused_train_loop", "fused_grad_step")),
                       (fal, ("fused_adaptive_train_loop",)),
                       (fs, SQNXT_KERNELS),
                       (cs, STENCIL_KERNELS),
                       (probe, ("probe_smem",))):
        for name in names:
            out[name] = (getattr(mod, name), "launches")
    for name in SQNXT_KERNELS:
        out[name + "_bf16"] = (getattr(fs, name), "launches_bf16")
    if set(out) != set(KERNELS):
        raise AssertionError(f"kernel_wrappers misses "
                             f"{sorted(set(KERNELS) ^ set(out))}")
    return out


def zero_launches(wrappers):
    for w, attr in wrappers.values():
        setattr(w, attr, 0)


def read_launches(wrappers):
    return {k: getattr(w, attr) for k, (w, attr) in wrappers.items()}


def flat_grads(model):
    """Every parameter's gradient, flattened in fp64 on the CPU (0 where a
    parameter got none)."""
    import torch

    return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .reshape(-1).double().cpu()
                      for p in model.parameters()])


def cosine(a, b):
    return float(a @ b / (a.norm() * b.norm()))


def ffjord_grad(tab, model, x, e):
    """(NLL, flat fp64 gradient on the CPU) of one miniboone iteration's
    loss through the discrete adjoint, on the probe ``e``."""
    model.zero_grad(set_to_none=True)
    total, nll = tab.nll_and_regs(model, x, (), True, probes=[e])
    total.backward()
    return float(nll.detach()), flat_grads(model)


def profile_spans(label, spans):
    """One traced iteration run as ``spans``, (name, callable) pairs called
    in turn: its wall time, each span's host time, the device's busy share
    and its top kernels. Raises where the profiler recorded no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for name, fn in spans:
            with record_function("span:" + name):
                fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels, busy_us = device_kernels(events)
    times, per_kernel = {}, {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("span:"):
            times[e.name[5:]] = times.get(e.name[5:], 0.0) \
                + e.time_range.elapsed_us() * 1e-3
    for e in kernels:
        us, n = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = busy_us * 1e-6 / wall
    log(f"{label} one traced iteration: {1e3 * wall:.2f} ms, device "
        f"busy {busy:.3f} of it ({busy_us * 1e-3:.2f} ms of kernels, "
        f"{len(kernels)} launches); host spans ms: " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(times.items())))
    for name, (us, n) in sorted(per_kernel.items(),
                                key=lambda kv: -kv[1][0])[:6]:
        log(f"{label}   {us * 1e-3:8.3f} ms x{n:<4d} {name[:90]}")
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    return {"wall_ms": 1e3 * wall, "busy": busy, "spans_ms": times,
            "kernel_ms": busy_us * 1e-3, "device_launches": len(kernels)}


def profile_ffjord(tab, model, opt, x, gen):
    """One traced miniboone iteration: spans solve (the forward solve with
    the loss), adjoint and Adam."""
    box = {}

    def solve():
        box["total"] = tab.nll_and_regs(model, x, (), True, generator=gen)[0]

    def adjoint():
        opt.zero_grad(set_to_none=True)
        box["total"].backward()

    return profile_spans("[ffjord] (a)", [("solve", solve),
                                          ("adjoint", adjoint),
                                          ("adam", opt.step)])


def phase_ffjord_tabular(device, wrappers):
    """14(a): examples/ffjord_tabular_torch.py's miniboone recipe at full
    width (D 43, 860-860, concatsquash, softplus, rk4 dt 0.25 over T 1, B
    1000, a Rademacher probe, Adam at 1e-3 with weight decay 1e-6) on the
    synthetic surrogate, through the driver's own functions. One
    iteration's gradient on the card in fp32 against the port's CPU fp64
    gradient at the same weights, batch and probe (cosine above
    FFJORD_COS); the brute-force NLL of the first 1,000 test rows before
    and after; FFJORD_WARM warm and FFJORD_ITERS timed iterations
    (iterations/s, NFE-F per iteration, peak device memory), one traced
    iteration (the busy share). The kernels' launch counts are zeroed
    before the training iterations and read after: the FFJORD path runs
    no hand-written kernel. Returns (report, model, data)."""
    import torch

    from pnode_tpu_torch.ffjord import sample_probe
    from pnode_tpu_torch.ffjord.datasets import load_tabular

    tab = load_example("ffjord_tabular_torch")
    args, _ = tab.parse_args(["--device", device])
    data = load_tabular(args.data)
    D, B = data.dim, args.batch_size
    model = tab.build_model(args, D, [], device, torch.float32)
    state0 = {k: v.detach().cpu().double()
              for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[ffjord] (a) miniboone recipe: D {D}, hidden "
        f"{(args.hdim_factor * D,) * args.nhidden}, {args.layer_type}, "
        f"{args.nonlinearity}, {args.solver} dt {args.step_size} over T "
        f"{args.time_length}, B {B}, Adam lr {args.lr} wd "
        f"{args.weight_decay}; {n_params} parameters; surrogate data "
        f"{data.synthetic} ({len(data.trn)} training rows)")
    rng = np.random.default_rng(args.seed)
    x_np = data.trn[rng.integers(0, len(data.trn), B)]
    e = sample_probe((B, D), torch.float64,
                     generator=torch.Generator().manual_seed(args.seed))
    t0 = time.perf_counter()
    l_k, g_k = ffjord_grad(tab, model, torch.as_tensor(
        x_np, dtype=torch.float32, device=device), e.float().to(device))
    t_card = time.perf_counter() - t0
    cpu_model = tab.build_model(args, D, [], "cpu", torch.float64)
    cpu_model.load_state_dict(state0)
    t0 = time.perf_counter()
    l_c, g_c = ffjord_grad(tab, cpu_model, torch.as_tensor(
        x_np, dtype=torch.float64), e)
    t_cpu = time.perf_counter() - t0
    cos = cosine(g_k, g_c)
    ok_grad = cos > FFJORD_COS and np.isfinite(l_k)
    log(f"[ffjord] (a) one iteration's gradient: card fp32 (NLL {l_k:.6f}, "
        f"{t_card:.2f} s with the first call) against the port's CPU fp64 "
        f"run (NLL {l_c:.6f}, {t_cpu:.2f} s): cosine {cos:.8f} (tol > "
        f"{FFJORD_COS}), NLL {abs(l_k - l_c) / abs(l_c):.3e} relative "
        f"{'ok' if ok_grad else 'FAIL'}")

    x_tst = torch.as_tensor(data.tst[:1000], dtype=torch.float32,
                            device=device)
    t0 = time.perf_counter()
    exact0 = tab.exact_nll(model, x_tst)
    t_exact = time.perf_counter() - t0
    opt = tab.make_optimizer(model, args)
    gen = torch.Generator().manual_seed(args.seed)
    batches = [torch.as_tensor(data.trn[rng.integers(0, len(data.trn), B)],
                               dtype=torch.float32, device=device)
               for _ in range(FFJORD_WARM + FFJORD_ITERS + 1)]
    zero_launches(wrappers)
    nfe0 = tab.nfe_total(model)
    losses = [tab.train_step(model, opt, x, (), 1.0, generator=gen)
              for x in batches[:FFJORD_WARM]]
    nfe_iter = (tab.nfe_total(model) - nfe0) / FFJORD_WARM
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for x in batches[FFJORD_WARM:FFJORD_WARM + FFJORD_ITERS]:
        losses.append(tab.train_step(model, opt, x, (), 1.0, generator=gen))
    torch.cuda.synchronize()
    its = FFJORD_ITERS / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trace = profile_ffjord(tab, model, opt, batches[-1], gen)
    counts = read_launches(wrappers)
    losses = torch.stack(losses).cpu().numpy()
    t0 = time.perf_counter()
    exact1 = tab.exact_nll(model, x_tst)
    ok = (ok_grad and np.all(np.isfinite(losses)) and np.isfinite(exact0)
          and np.isfinite(exact1) and nfe_iter == 16
          and not any(counts.values()))
    log(f"[ffjord] (a) {FFJORD_WARM} + {FFJORD_ITERS} Adam iterations: NLL "
        f"{np.array2string(losses, precision=4, max_line_width=240)}; "
        f"{its:.3f} iterations/s ({B * its:.0f} rows/s) over the "
        f"{FFJORD_ITERS}; NFE-F {nfe_iter:g} per iteration (NFE-B equal); "
        f"peak device memory {peak:.3f} GiB (max_memory_allocated); "
        f"brute-force NLL of tst[:1000] {exact0:.6f} before ({t_exact:.2f} "
        f"s), {exact1:.6f} after ({time.perf_counter() - t0:.2f} s); "
        f"hand-written kernel launches over the iterations: "
        f"{sum(counts.values())} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 14(a), the miniboone recipe, failed")
    return {"its": its, "nfe_iter": nfe_iter, "peak_gib": peak,
            "cos": cos, "exact": (exact0, exact1), "trace": trace,
            "launches": counts}, model, data


def phase_ffjord_roundtrip(device, model, data):
    """14(b): x -> z -> x on the card through the trained miniboone model
    (forward, then the time-flipped reverse solve, one probe): x within
    FFJORD_TRIP of max |x|, delta_logp cancelling to FFJORD_TRIP."""
    import torch

    from pnode_tpu_torch.ffjord import sample_probe

    x = torch.as_tensor(data.tst[:1000], dtype=torch.float32, device=device)
    e = sample_probe(tuple(x.shape), torch.float32,
                     generator=torch.Generator().manual_seed(5), device=device)
    with torch.no_grad():
        z, dlp, _ = model.apply(x, probes=[e], training=False)
        x_back, dlp_back, _ = model.apply(z, probes=[e], training=False,
                                          reverse=True)
    err_x = float((x_back - x).abs().max() / x.abs().max())
    err_d = float((dlp + dlp_back).abs().max())
    ok = err_x <= FFJORD_TRIP and err_d <= FFJORD_TRIP
    log(f"[ffjord] (b) round trip x -> z -> x of tst[:1000] on the card "
        f"(fp32): max |x_back - x| / max |x| {err_x:.3e}, max |dlp + "
        f"dlp_back| {err_d:.3e} (|dlp| up to "
        f"{float(dlp.abs().max()):.3f}; tol {FFJORD_TRIP}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 14(b), the round trip, failed")
    return {"err_x": err_x, "err_dlp": err_d}


def phase_ffjord_gate5(device):
    """14(c): tools/hardware_smoke.py's gate 5: ODENVP((8, 8, 1), 2 scales,
    1 block, hidden 8, rk4 0.25) takes GATE5_STEPS Adam steps at 1e-3 on
    16 images (numpy seed 7, 0.05 + 0.9 U[0, 1)); the NLL on a fixed probe
    (a generator seeded 99) falls and every gradient is finite."""
    import torch

    from pnode_tpu_torch.ffjord import ODENVP

    torch.manual_seed(3)
    model = ODENVP((8, 8, 1), n_scales=2, n_blocks=1, hidden_dims=(8,),
                   step_size=0.25, device=device)
    x = torch.as_tensor(np.random.default_rng(7).random((16, 8, 8, 1)),
                        dtype=torch.float32, device=device) * 0.9 + 0.05
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def fixed_nll():
        with torch.no_grad():
            lp, _ = model.log_prob(x, generator=torch.Generator()
                                   .manual_seed(99))
        return float(-lp.mean())

    nll0 = fixed_nll()
    finite = True
    t0 = time.perf_counter()
    for i in range(GATE5_STEPS):
        lp, _ = model.log_prob(x, generator=torch.Generator()
                               .manual_seed(10 + i))
        opt.zero_grad(set_to_none=True)
        (-lp.mean()).backward()
        finite = finite and all(bool(torch.isfinite(p.grad).all())
                                for p in model.parameters())
        opt.step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nll1 = fixed_nll()
    ok = finite and nll1 < nll0
    log(f"[ffjord] (c) hardware gate 5, ODENVP((8, 8, 1)) {GATE5_STEPS} "
        f"Adam steps: fixed-probe NLL {nll0:.4f} -> {nll1:.4f}, gradients "
        f"finite {finite}, {GATE5_STEPS / secs:.2f} steps/s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 14(c), hardware gate 5, failed")
    return {"nll": (nll0, nll1), "steps_per_s": GATE5_STEPS / secs}


def phase_ffjord_drivers():
    """14(d): examples/ffjord_image_torch.py (ODENVP on the MNIST
    surrogate, B 64) and ffjord_toy_torch.py (8gaussians, B 512, dopri5)
    at their defaults for a few iterations, each in a subprocess in turn:
    finite losses, iterations/s and images (samples)/s."""
    res = {}
    for name, argv in FFJORD_DRIVERS.items():  # one at a time on the card
        out = "--train_dir" if name == "ffjord_image_torch" else "--save"
        res[name] = finish_driver(start_driver(
            name, argv + [out, os.path.join(ROOT, "build", name)]))
    img, toy = res["ffjord_image_torch"], res["ffjord_toy_torch"]
    img_its = img["iters"] / img["seconds"]
    toy_its = len(toy["losses"]) / toy["seconds"]
    ok = (np.all(np.isfinite(img["bpd"])) and np.all(np.isfinite(
        toy["losses"])) and img["iters"] > 0)
    log(f"[ffjord] (d) ffjord_image_torch.py "
        f"{' '.join(FFJORD_DRIVERS['ffjord_image_torch'])}: bits/dim "
        f"{img['bpd'][0]:.4f} -> {img['bpd'][-1]:.4f}, {img_its:.3f} "
        f"iterations/s, {img['images_per_s']:.1f} images/s (B 64, the first "
        f"iteration included)")
    log(f"[ffjord] (d) ffjord_toy_torch.py "
        f"{' '.join(FFJORD_DRIVERS['ffjord_toy_torch'])}: NLL "
        f"{toy['losses'][0]:.4f} -> {toy['losses'][-1]:.4f}, {toy_its:.3f} "
        f"iterations/s, {512 * toy_its:.0f} samples/s (the first iteration "
        f"included) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 14(d), the FFJORD drivers, failed")
    return {"image_its": img_its, "image_ips": img["images_per_s"],
            "toy_its": toy_its}


def phase_ffjord(device):
    """Phase 14: FFJORD on the card, (a)-(c) in this process, then (d)'s
    drivers in subprocesses (one at a time: nothing else runs on the card
    while (a) is timed)."""
    t0 = time.perf_counter()
    wrappers = kernel_wrappers()
    report, model, data = phase_ffjord_tabular(device, wrappers)
    report["roundtrip"] = phase_ffjord_roundtrip(device, model, data)
    report["gate5"] = phase_ffjord_gate5(device)
    report["drivers"] = phase_ffjord_drivers()
    log(f"[ffjord] phase 14 took {time.perf_counter() - t0:.1f} s")
    return report


# -- phase 15: GRAND ----------------------------------------------------------

# Cora's scale (2,708 nodes, 1,433 features, 7 classes, ~5,280 undirected
# edges; homophily ~0.81) as the SBM surrogate: the Planetoid files are not
# in the repository
CORA = dict(n_nodes=2708, n_classes=7, feat_dim=1433, p_in=0.0082,
            p_out=0.00032, seed=0)
# grand_node_torch.py's defaults but these flags, with the full-batch
# epochs before the timed ones and the timed ones: transformer/imex's
# epoch is ~3 s (GMRES's whole cycle per stage solve), so it takes 1 + 2
GRAND_CONFIGS = {
    "laplacian/pnode": ([], 3, 10),
    "transformer/imex": (["--function", "transformer", "--block", "imex"],
                         1, 2),
}
GRAND_COS = 0.9999       # card fp32 gradient against the CPU fp64 one
GRAND_LOSS_RTOL = 1e-5   # and their losses
GATE6_STEPS, GATE6B_STEPS = 8, 12  # tools/hardware_smoke.py's gate 6
MNIST_B, MNIST_ITERS = 256, 20     # (c): GRANDImage at MNIST's shape
GRAND_DRIVERS = {                  # (d), at their defaults otherwise
    "grand_node_torch": ["--epochs", "10"],
    "grand_image_torch": ["--epochs", "1"],
    "grand_sweep_torch": ["--scheduler", "random", "--trials", "1",
                          "--epochs", "3"],
}


def grand_grad(gn, model, x, y, mask):
    """(masked CE, flat gradient) of one full-batch step through the
    discrete adjoint, dropout off."""
    model.zero_grad(set_to_none=True)
    loss = gn.masked_ce(model(x, training=True), y, mask)
    loss.backward()
    return float(loss.detach()), flat_grads(model)


def grand_config(gn, name, data, device, wrappers):
    """15(a) for one configuration: the gradient gate against the port's
    CPU fp64 run at the same weights, its warm and timed epochs (an AdamW step with dropout, then the evaluation), one
    traced epoch; the kernels' launch counts over the epochs."""
    import torch

    flags, n_warm, n_timed = GRAND_CONFIGS[name]
    args, _ = gn.parse_args(["--device", device] + flags)
    graph, _ = gn.build_graph(args, data)
    n_cls, in_dim = int(data["y"].max()) + 1, data["x"].shape[1]
    model = gn.build_model(args, graph, in_dim, n_cls, device, torch.float32)
    state0 = {k: v.detach().cpu().double()
              for k, v in model.state_dict().items()}
    x, y, masks, _ = gn.to_device(data, None, device, torch.float32)
    t0 = time.perf_counter()
    l_k, g_k = grand_grad(gn, model, x, y, masks["train_mask"])
    t_card = time.perf_counter() - t0
    cpu = gn.build_model(args, graph, in_dim, n_cls, "cpu", torch.float64)
    cpu.load_state_dict(state0)
    xc, yc, mc, _ = gn.to_device(data, None, "cpu", torch.float64)
    t0 = time.perf_counter()
    l_c, g_c = grand_grad(gn, cpu, xc, yc, mc["train_mask"])
    t_cpu = time.perf_counter() - t0
    cos, l_rel = cosine(g_k, g_c), abs(l_k - l_c) / abs(l_c)
    ok_grad = cos >= GRAND_COS and l_rel <= GRAND_LOSS_RTOL
    n_par = sum(p.numel() for p in model.parameters())
    method = ("ARK IMEX, Newton on GMRES" if args.block == "imex"
              else args.method)
    log(f"[grand] (a) {name} (hidden {args.hidden_dim}, {method} dt "
        f"{args.step_size} over T {args.time}, {n_par} parameters): one CE "
        f"gradient through the adjoint, card fp32 (CE {l_k:.7f}, "
        f"{t_card:.2f} s with the first call) against the port's CPU fp64 "
        f"(CE {l_c:.7f}, {t_cpu:.2f} s): cosine {cos:.8f} (tol >= "
        f"{GRAND_COS}), CE {l_rel:.3e} relative (tol {GRAND_LOSS_RTOL}) "
        f"{'ok' if ok_grad else 'FAIL'}")

    opt = gn.make_optimizer(model, args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    mask = masks["train_mask"]

    def epoch():
        loss = gn.train_step(model, opt, x, y, mask, gen)
        return loss, gn.accuracy(model, x, y, masks)

    zero_launches(wrappers)
    losses = [epoch()[0] for _ in range(n_warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        loss, accs = epoch()
        losses.append(loss)
    torch.cuda.synchronize()
    eps = n_timed / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    box = {}

    def forward():
        box["loss"] = gn.masked_ce(model(x, training=True, generator=gen),
                                   y, mask)

    def adjoint():
        opt.zero_grad(set_to_none=True)
        box["loss"].backward()

    trace = profile_spans(f"[grand] (a) {name}", [
        ("forward", forward), ("adjoint", adjoint), ("adamw", opt.step),
        ("eval", lambda: gn.accuracy(model, x, y, masks))])
    counts = read_launches(wrappers)
    losses = torch.stack(losses).cpu().numpy()
    ok = (ok_grad and np.all(np.isfinite(losses)) and losses[-1] < losses[0]
          and not any(counts.values()))
    log(f"[grand] (a) {name}: {n_warm} + {n_timed} AdamW epochs "
        f"(lr {args.lr}, wd {args.decay}, dropout {args.input_dropout} / "
        f"{args.dropout}): CE "
        f"{np.array2string(losses, precision=4, max_line_width=260)}; "
        f"{eps:.3f} epochs/s over the {n_timed}; peak device memory "
        f"{peak:.3f} GiB; accuracy train {accs['train_mask']:.3f} val "
        f"{accs['val_mask']:.3f} test {accs['test_mask']:.3f}; hand-written "
        f"kernel launches {sum(counts.values())} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 15(a), GRAND {name}, failed")
    return {"cos": cos, "ce_rel": l_rel, "epochs_per_s": eps,
            "peak_gib": peak, "accs": accs, "losses": losses.tolist(),
            "trace": trace}


def phase_grand_cora(device, wrappers):
    """15(a): node classification at Cora's scale, grand_node_torch.py's
    defaults (hidden 64, dopri5 dt 0.5 over T 3, AdamW lr 0.01 wd 5e-4,
    dropout 0.5 / 0.5 from a seeded generator on the card) through the
    driver's functions, for each of GRAND_CONFIGS."""
    from pnode_tpu_torch.models.grand import synthetic_sbm

    gn = load_example("grand_node_torch")
    t0 = time.perf_counter()
    data = synthetic_sbm(**CORA)
    E = data["edge_index"].shape[1]
    src, dst = data["edge_index"]
    homophily = float(np.mean(data["y"][src] == data["y"][dst]))
    log(f"[grand] (a) Cora-scale SBM: {len(data['y'])} nodes, "
        f"{data['x'].shape[1]} features, {int(data['y'].max()) + 1} classes, "
        f"{E} directed edges ({E + len(data['y'])} with self loops), "
        f"homophily {homophily:.3f}, train/val/test "
        f"{int(data['train_mask'].sum())}/{int(data['val_mask'].sum())}/"
        f"{int(data['test_mask'].sum())} ({time.perf_counter() - t0:.2f} s "
        f"to draw)")
    return {name: grand_config(gn, name, data, device, wrappers)
            for name in GRAND_CONFIGS}


def phase_grand_gate6(device):
    """15(b): tools/hardware_smoke.py's gate 6: the six families on a
    96-node SBM (hidden 16, dopri5 dt 0.25 over T 1, dropout off) take
    GATE6_STEPS Adam steps at 5e-3 on the mean CE through the adjoint;
    the CE falls and every gradient is finite. 6b: GRANDImage at 8 x 8
    (rk4) takes GATE6B_STEPS Adam steps at 5e-2 on 32 quadrant blobs; the
    CE falls."""
    import torch
    import torch.nn.functional as F

    from pnode_tpu_torch.models.grand import (
        GRANDModel, gcn_norm_adj, get_rw_adj, synthetic_sbm)
    from pnode_tpu_torch.models.grand_image import GRANDImage

    def train(model, x, y, lr, steps):
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        losses, finite = [], True
        for _ in range(steps):
            loss = F.cross_entropy(model(x, training=True), y)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            finite = finite and all(bool(torch.isfinite(p.grad).all())
                                    for p in model.parameters()
                                    if p.grad is not None)
            opt.step()
            losses.append(float(loss.detach()))
        return losses, finite

    data = synthetic_sbm(n_nodes=96, n_classes=3, feat_dim=16, seed=0)
    graph = get_rw_adj(data["edge_index"], 96)
    graph_gcn = gcn_norm_adj(data["edge_index"], 96)
    x = torch.as_tensor(data["x"], device=device)
    y = torch.as_tensor(data["y"], dtype=torch.int64, device=device)
    families = [
        ("transformer/pnode", dict(function="transformer"), graph),
        ("gat/pnode", dict(function="gat"), graph),
        ("hbnode/heavyball", dict(function="hbnode", block="heavyball"),
         graph),
        ("cgnn/pnode", dict(function="cgnn"), graph_gcn),
        ("laplacian/hard_att", dict(block="hard_att", att_samp_pct=0.7),
         graph),
        ("laplacian/rewire_att", dict(block="rewire_att", rw_addD=0.25),
         graph),
    ]
    res, ok_all = {}, True
    for name, kw, g in families:
        torch.manual_seed(4)
        model = GRANDModel(g, 16, 16, 3, T=1.0, step_size=0.25,
                           method="dopri5", input_dropout=0.0, dropout=0.0,
                           device=device, **kw)
        t0 = time.perf_counter()
        losses, finite = train(model, x, y, 5e-3, GATE6_STEPS)
        secs = time.perf_counter() - t0
        ok = finite and losses[-1] < losses[0]
        ok_all = ok_all and ok
        res[name] = {"ce": (losses[0], losses[-1]), "seconds": secs}
        log(f"[grand] (b) gate 6 {name}: ce {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} over {GATE6_STEPS} Adam steps, gradients "
            f"finite {finite}, {GATE6_STEPS / secs:.2f} steps/s "
            f"{'ok' if ok else 'FAIL'}")

    rng = np.random.default_rng(0)
    ys = rng.integers(0, 4, size=32)
    xs = np.zeros((32, 8, 8, 1), np.float32)
    for i, c in enumerate(ys):
        oy, ox = (c // 2) * 4, (c % 2) * 4
        xs[i, oy + 1: oy + 3, ox + 1: ox + 3, 0] = 1.0
    xs += rng.normal(scale=0.15, size=xs.shape).astype(np.float32)
    torch.manual_seed(0)
    model = GRANDImage(8, 8, 4, T=1.0, step_size=0.25, method="rk4",
                       input_dropout=0.0, dropout=0.0, device=device)
    losses, finite = train(model, torch.as_tensor(xs, device=device),
                           torch.as_tensor(ys, device=device), 5e-2,
                           GATE6B_STEPS)
    ok = finite and np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    ok_all = ok_all and ok
    res["image"] = {"ce": (losses[0], losses[-1])}
    log(f"[grand] (b) gate 6b GRANDImage 8x8: ce {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {GATE6B_STEPS} Adam steps "
        f"{'ok' if ok else 'FAIL'}")
    if not ok_all:
        raise AssertionError("phase 15(b), hardware gate 6, failed")
    return res


def phase_grand_image(device):
    """15(c): GRANDImage at MNIST's shape (28 x 28, 10 classes, B 256, rk4
    dt 0.25 over T 1, dropout off) on seeded random pixels: one CE
    gradient through the adjoint on the card in fp32 against the port's
    CPU fp64 run at the same weights (cosine >= GRAND_COS), then
    MNIST_ITERS timed Adam iterations (images/s, peak memory) and one
    traced iteration."""
    import torch
    import torch.nn.functional as F

    from pnode_tpu_torch.models.grand_image import GRANDImage

    rng = np.random.default_rng(0)
    xs = rng.random((MNIST_B, 28, 28, 1), dtype=np.float32)
    ys = rng.integers(0, 10, MNIST_B)

    def build(dev, dtype):
        torch.manual_seed(0)
        return GRANDImage(28, 28, 10, T=1.0, step_size=0.25, method="rk4",
                          input_dropout=0.0, dropout=0.0, device=dev,
                          dtype=dtype)

    def grad(model, dev, dtype):
        model.zero_grad(set_to_none=True)
        loss = F.cross_entropy(
            model(torch.as_tensor(xs, dtype=dtype, device=dev),
                  training=True),
            torch.as_tensor(ys, dtype=torch.int64, device=dev))
        loss.backward()
        return float(loss.detach()), flat_grads(model)

    model = build(device, torch.float32)
    l_k, g_k = grad(model, device, torch.float32)
    l_c, g_c = grad(build("cpu", torch.float64), "cpu", torch.float64)
    cos, l_rel = cosine(g_k, g_c), abs(l_k - l_c) / abs(l_c)
    x = torch.as_tensor(xs, device=device)
    y = torch.as_tensor(ys, dtype=torch.int64, device=device)
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    box = {}

    def forward():
        box["loss"] = F.cross_entropy(model(x, training=True), y)

    def adjoint():
        opt.zero_grad(set_to_none=True)
        box["loss"].backward()

    for _ in range(2):  # warm
        forward()
        adjoint()
        opt.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(MNIST_ITERS):
        forward()
        adjoint()
        opt.step()
        losses.append(box["loss"].detach())
    torch.cuda.synchronize()
    ips = MNIST_B * MNIST_ITERS / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trace = profile_spans("[grand] (c)", [("forward", forward),
                                          ("adjoint", adjoint),
                                          ("adam", opt.step)])
    losses = torch.stack(losses).cpu().numpy()
    ok = cos >= GRAND_COS and np.all(np.isfinite(losses))
    log(f"[grand] (c) GRANDImage 28x28, B {MNIST_B}, rk4 0.25 over T 1: "
        f"one CE gradient, card fp32 (CE {l_k:.7f}) against CPU fp64 (CE "
        f"{l_c:.7f}): cosine {cos:.8f} (tol >= {GRAND_COS}), CE "
        f"{l_rel:.3e} relative; {MNIST_ITERS} Adam iterations: CE "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, {ips:.1f} images/s, peak "
        f"device memory {peak:.3f} GiB {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 15(c), GRANDImage at MNIST's shape, "
                             "failed")
    return {"cos": cos, "ce_rel": l_rel, "images_per_s": ips,
            "peak_gib": peak, "trace": trace}


def phase_grand_drivers():
    """15(d): examples/grand_node_torch.py (10 epochs), grand_image_torch.py
    (one epoch of the surrogate) and grand_sweep_torch.py (one random
    trial of 3 epochs), at their defaults otherwise, each in a subprocess,
    all three at once (their start-up, ~15 s a process, is most of their
    time; the rates they report share the host)."""
    t0 = time.perf_counter()
    runs = {name: start_driver(name, argv + (
        [] if name == "grand_image_torch" else
        ["--train_dir", os.path.join(ROOT, "build", name)]))
        for name, argv in GRAND_DRIVERS.items()}
    res = {}
    for name, run in runs.items():
        res[name] = finish_driver(run)
        res[name]["wall_s"] = time.perf_counter() - t0
    node, img = res["grand_node_torch"], res["grand_image_torch"]
    trials = res["grand_sweep_torch"]["trials"]
    ok = (np.all(np.isfinite(node["losses"])) and node["epochs"] == 10
          and np.all(np.isfinite(img["losses"])) and len(trials) == 1
          and trials[0][2] >= 0)
    log(f"[grand] (d) grand_node_torch.py --epochs 10: CE "
        f"{node['losses'][0]:.4f} -> {node['losses'][-1]:.4f}, best val "
        f"{node['best_val']:.4f} (test {node['best_test']:.4f}), "
        f"{node['epochs'] / node['seconds']:.2f} epochs/s, done "
        f"{node['wall_s']:.1f} s after the start")
    log(f"[grand] (d) grand_image_torch.py --epochs 1: loss "
        f"{img['losses'][0]:.4f}, test acc {img['test_acc'][0]:.4f}, "
        f"{img['images_per_s']:.1f} images/s ({img['iters']} iterations, "
        f"the first included), done {img['wall_s']:.1f} s after the start")
    log(f"[grand] (d) grand_sweep_torch.py "
        f"{' '.join(GRAND_DRIVERS['grand_sweep_torch'])}: trial "
        f"{trials[0][0]} -> best val {trials[0][2]:.4f}, done "
        f"{res['grand_sweep_torch']['wall_s']:.1f} s after the start "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 15(d), the GRAND drivers, failed")
    return res


def phase_grand(device):
    """Phase 15: GRAND on the card, (a)-(c) in this process, then (d)'s
    drivers in subprocesses. The kernels' launch counts are zeroed at the
    start and must read 0 after (c): the GRAND path runs no hand-written
    kernel."""
    t0 = time.perf_counter()
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    report = {"cora": phase_grand_cora(device, wrappers)}
    report["gate6"] = phase_grand_gate6(device)
    report["mnist"] = phase_grand_image(device)
    counts = read_launches(wrappers)
    log(f"[grand] hand-written kernel launches over phase 15(a)-(c): "
        f"{sum(counts.values())}")
    if any(counts.values()):
        raise AssertionError(f"phase 15 launched kernels: {counts}")
    report["drivers"] = phase_grand_drivers()
    log(f"[grand] phase 15 took {time.perf_counter() - t0:.1f} s")
    return report


def main():
    import torch

    t_start = time.perf_counter()
    phase_device()
    tensor_cores = phase_build()
    probe_report = phase_probe()
    tensor_cores()
    u = ks_data()
    reports = phase_kernels("cuda", u)
    counts, _, _ = phase_slice("cuda", u)
    adaptive_counts = phase_adaptive_slice("cuda", u)
    # K3 runs on both slices' paths: its count is the fixed-step path's
    counts["fused_ark_step_fwd_embedded"] = adaptive_counts[
        "fused_ark_step_fwd_embedded"]
    counts["fused_adaptive_train_loop"] = adaptive_counts[
        "fused_adaptive_train_loop"]
    tab = ks_operators("cuda")[2]
    for name, (flops, byts) in ks_costs(
            tab, reports["fused_adaptive_train_loop"]).items():
        reports[name]["bound_ms"], reports[name]["bound_by"] = bound(flops,
                                                                     byts)
    sq_reports, sq_counts, fp32_ips = phase_cifar("cuda")
    reports.update(sq_reports)
    counts.update(sq_counts)
    b_reports, b_launches, k1_burgers = phase_burgers("cuda")
    reports.update(b_reports)
    counts.update({name: b_launches[name] for name in STENCIL_KERNELS})
    burgers12 = reports["fused_grad_step"]["burgers"]
    reports["fused_grad_step"], counts["fused_grad_step"], \
        burgers12["launches"] = phase_dp("cuda", u)
    reports["fused_grad_step"]["burgers"] = burgers12
    ks_grid = reports["fused_grad_step"].pop("ks_grid")
    reports["fused_grad_step"]["ks_grid"] = ks_grid["k12"]
    reports["fused_ark_step_fwd"]["ks_grid"] = ks_grid["k2"]
    for name in ("fused_ark_step_fwd", "fused_ark_step_adj",
                 "fused_train_loop"):
        reports[name]["burgers"]["launches"] = b_launches[name]
    theta_launches, _ = phase_theta("cuda", u)
    slice5_launches, replay, k1_ks = phase_slice5("cuda", u)
    slice5b_launches = phase_slice5b("cuda", u)
    bf_reports, bf_counts = phase_cifar_bf16("cuda", fp32_ips)
    reports.update(bf_reports)
    counts.update(bf_counts)
    slice10_launches = phase_slice10("cuda", u)
    phase_ffjord("cuda")
    phase_grand("cuda")
    reports["probe_smem"] = probe_report
    counts["probe_smem"] = probe_report["launches"]
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = reports[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r.get("library_ms")})
        for extra in ("device_ms", "device_source", "stage2", "stage3",
                      "library_device_ms",
                      "launch_floor_device_ms", "with_dw", "ks_stage",
                      "fp32_ms", "module_ms", "max_rel_err",
                      "free_norm_err", "free_max_rel_err", "burgers",
                      "ks_grid"):
            if extra in r:
                kernels[-1][extra] = r[extra]
        if name in k1_burgers:  # K1's readings at the Burgers stack too
            kernels[-1]["burgers"] = k1_burgers[name]
        if name in theta_launches:  # launches over phase 9's paths
            kernels[-1]["theta_launches"] = theta_launches[name]
        if name in slice5_launches:  # launches over phase 10's paths
            kernels[-1]["slice5_launches"] = slice5_launches[name]
        if name in slice5b_launches:  # launches over phase 11's paths
            kernels[-1]["slice5b_launches"] = slice5b_launches[name]
        if name in slice10_launches:  # launches over phase 13's gates
            kernels[-1]["slice10_launches"] = slice10_launches[name]
        if name in k1_ks:  # K1's device time per call at the KS stack
            kernels[-1]["device_ms"] = k1_ks[name]
        mine = {k: {"us_per_launch": us, "launches": per}
                for k, (us, per) in replay.items()
                if k in REPLAY_NAMES.get(name, ())}
        if mine:  # one replayed step of phase 10(a), traced
            kernels[-1]["replayed_step"] = mine
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
