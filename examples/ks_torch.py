"""KS (Kuramoto-Sivashinsky) SINODE training on the PyTorch/CUDA port.

Twin of ``examples/ks.py``: learned chaotic-PDE dynamics on a 64-point L=22
grid, one-step windows trained with Adam through
``ODESolver.odeint_adjoint`` and its hand-written discrete adjoint, a
plateau LR decay on the validation loss. ``--pnode_model`` picks the model:
``imex`` (f_IM the fixed 5-point stencil, f_EX = -MLP 64 -> 104 x4 -> 64),
``snode`` (conv - MLP, one function) or ``mlp`` (a sigmoid MLP), the last
two integrated by ``--pnode_method``::

    python examples/ks_torch.py                       # the H100 (default)
    python examples/ks_torch.py --device cpu --max_epochs 1 --data_size 80 \
        --batch_size 16
    python examples/ks_torch.py --pnode_model imex --linear_solver hpddm \
        --fixed_jacobian                              # the main path
    python examples/ks_torch.py --pnode_model imex --linear_solver hpddm \
        --fixed_jacobian --fused_loop                 # one launch per epoch
    python examples/ks_torch.py --pnode_model imex --linear_solver hpddm \
        --fixed_jacobian -ts_adapt_type basic -ts_rtol 1e-4 \
        -ts_atol 1e-4                                 # adaptive, per step
    python examples/ks_torch.py --pnode_model snode --pnode_method rk4
    python examples/ks_torch.py --pnode_model imex --node   # autodiff baseline

The defaults are ``examples/ks.py``'s: ``--pnode_model snode``, integrated
by ``--pnode_method cn`` with Newton (PETSc's newtonls) on matrix-free
GMRES stage solves (``--linear_solver petsc``) against an unfrozen
Jacobian, and ``--use_fused``, which puts snode's stencil on K10/K11 (its
MLP stays on ``nn.Linear``: the GMRES matvec is forward mode, which K1
has no rule for). ``snode`` and ``mlp`` take ``--pnode_method`` ``cn`` or
``beuler``, the theta methods, or an explicit RK method (euler, rk2,
bosh3, rk4, dopri5, ...). The main path (``bench.py``'s recipe) is
``--pnode_model imex --linear_solver hpddm --fixed_jacobian``: ARK3 IMEX
against the frozen, pre-inverted stage operator, with ``-snes_type
ksponly`` (a programmatic default under ``--fixed_jacobian`` that a
command-line flag overrides), where ``--use_fused`` runs the fused MLP
and, on CUDA, the fused ARK step kernels, and the stencil on K10/K11
wherever the generic stage loop evaluates f_IM (``-pnode_fused_ark_adjoint
off``) and in the frozen Jacobian's assembly. ``--node`` (the reference's
torchdiffeq baseline) integrates the imex model's combined right-hand side
f_IM + f_EX by dopri5 at ``step_size / 100`` without the adjoint
(``enable_adjoint=False``), the gradients by autograd through the steps.
PETSc-style flags after the script's own options go to the port's options
database (``-ts_arkimex_type ars122``, ``-pnode_fused_ark_adjoint off``,
...). ``--device cuda`` raises when CUDA is absent: the CPU is an explicit
choice, never a fallback.

``--fused_loop`` (twin of ``examples/ks.py --fused_loop``) runs each epoch's
minibatches, stacked into (K, B, 64), as K iterations of the fused training
loop (K4: forward step, MSE, stage-exact reverse, Adam in optax's form) in
one call, carrying the weights and Adam moments across epochs; the plateau
LR goes in as its ``lr``. At the end of each epoch the loop's weights are
copied into the model, so validation runs through ``ode.odeint`` as before.
It needs the fused-kernel gate (``--use_fused``, ksponly, frozen Jacobian),
``--time_window_size 1`` and fp32; the CPU runs the loop's plain version.

Under ``-ts_adapt_type basic`` (PETSc's TSAdapt, with ``-ts_rtol``,
``-ts_atol``, ``-ts_adapt_*``) the per-step path trains through the
adaptive ``ODESolver``, the counterpart of ``examples/ks.py`` with the same
flag tail, and ``--fused_loop`` runs each epoch as one call of the fused
adaptive loop (K5: the embedded trial loop, MSE, the reverse of the
accepted trials and Adam per iteration), with ``bench.py``'s protocol for
that workload: a trial axis of ``-ts_adapt_max_steps`` (default 32) and
the first accepted dt of each call's last iteration as the next call's
initial dt. A call in which an iteration runs out of trials before its
window lands stops the training (``SystemExit``). The JAX package reaches
this kernel only through ``bench.py --workload adaptive``.

Training minibatches come from ``pnode_tpu_torch.data.WindowedLoader``, as
``examples/ks.py``'s do: the shared native loader (``csrc/windowed_loader.cpp``),
whose batches equal ``ks.py``'s bit for bit at the same ``--seed``, epoch
after epoch; validation is one full batch of ``make_batches`` under
``default_rng(0)``, as in ``ks.py``. The best validation loss's weights go
to ``best_<pnode_model>.ckpt`` in ``--train_dir`` (``epoch``, ``params``,
``best_val``, ``normalize``: the JAX package's pickle of numpy arrays,
``pnode_tpu_torch.utils.save_checkpoint``); ``--hotstart`` resumes from it
at the next epoch with its best validation loss, and refuses a checkpoint
of another ``--normalize``::

    python examples/ks_torch.py --max_epochs 2
    python examples/ks_torch.py --max_epochs 3 --hotstart   # epoch 2 on

``--dp N`` (twin of ``examples/ks.py --dp``) trains data-parallel over N
ranks of a ``torch.distributed`` group: every rank draws the same global
minibatch from the seed, solves its B/N rows, and one all-reduce per step
means the loss and the gradients before ``torch.optim.Adam`` (the per-step
path; ``--fused_loop`` is refused). N must divide ``--batch_size``; -1 is
the world size. The ranks come from ``torchrun`` (NCCL on CUDA, gloo on the
CPU); at ``--dp 1`` without it the script starts a one-rank group itself::

    torchrun --standalone --nproc_per_node 1 examples/ks_torch.py --dp 1
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, L = 64, 22.0


def parse_args(argv=None):
    p = argparse.ArgumentParser("KS (PyTorch port)")
    p.add_argument("--pnode_model", choices=["imex", "snode", "mlp"],
                   default="snode", help="snode (the default, as "
                   "examples/ks.py's), imex or mlp")
    p.add_argument("--pnode_method", type=str, default="cn",
                   help="stepper of snode and mlp: cn or beuler (the theta "
                   "methods, Newton on --linear_solver stage solves) or an "
                   "explicit RK method (euler, rk2, bosh3, rk4, dopri5, ...)")
    p.add_argument("--normalize", choices=["minmax", "mean"], default=None)
    p.add_argument("--step_size", type=float, default=0.2)
    p.add_argument("--data_size", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--time_window_size", type=int, default=1)
    p.add_argument("--time_window_endpoint", action="store_true")
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--validate_freq", type=int, default=1)
    p.add_argument("--implicit_form", action="store_true")
    p.add_argument("--double_prec", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train_dir", type=str, default="./train_results_ks_torch")
    p.add_argument("--hotstart", action="store_true",
                   help="resume from best_<pnode_model>.ckpt in --train_dir")
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--linear_solver", choices=["petsc", "hpddm", "torch"],
                   default="petsc", help="the implicit stages' solves: "
                   "petsc (matrix-free GMRES), hpddm (one shared dense "
                   "block) or torch (dense LU per batch row)")
    p.add_argument("--fixed_jacobian", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--use_fused", action=argparse.BooleanOptionalAction,
                   default=True, help="imex: fused MLP (K1) and, on the "
                   "fused gate, the ARK step kernels (K2, K3); the stencil "
                   "on K10/K11")
    p.add_argument("--fused_loop", action="store_true",
                   help="each epoch as K iterations of the fused training "
                   "loop (K4; K5 under -ts_adapt_type basic) in one call")
    p.add_argument("--node", action="store_true",
                   help="autodiff-through-solver baseline (the reference's "
                   "KS_node torchdiffeq comparison): imex's f_IM + f_EX by "
                   "dopri5 at step_size/100, gradients by autograd")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel training over N ranks (-1 = the "
                   "world size): each rank solves its shard of every "
                   "minibatch, one gradient mean per step "
                   "(pnode_tpu_torch.parallel). N must divide --batch_size")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_known_args(argv)


def start_dp(n, batch_size, device):
    """The --dp N mesh: the ranks of torchrun's group (or of one already
    started), or, at --dp 1 with neither, a one-rank group of our own (NCCL
    on CUDA, gloo on the CPU). Returns (mesh, whether we started the
    group)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from pnode_tpu_torch.parallel import make_mesh

    own = False
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:  # torchrun
            dist.init_process_group(backend)
        elif n in (1, -1):
            store = os.path.join(tempfile.mkdtemp(), "store")
            dist.init_process_group(backend, init_method="file://" + store,
                                    rank=0, world_size=1)
            own = True
        else:
            raise SystemExit(f"--dp {n} needs {n} ranks: run under torchrun "
                             f"--nproc_per_node {n}")
    world = dist.get_world_size()
    n = world if n < 0 else n
    if batch_size % n:
        raise SystemExit(f"--dp {n} must divide --batch_size {batch_size}")
    if n != world:
        raise SystemExit(f"--dp {n} needs {n} ranks, the group has {world}")
    print(f"data-parallel: {n} device(s), {batch_size // n} samples/device")
    return make_mesh(n), own


class FusedLoop:
    """The ``--fused_loop`` path: K4's operands from the fused step gate
    (``stepper.prepare`` + ``_fused_reverse_args``), and the explicit
    part's weights and Adam moments carried from call to call."""

    def __init__(self, ode, ex, batch_size, step_size):
        import torch

        from pnode_tpu_torch.ops.fused_train_loop import fused_train_loop_fits

        stp, gate = self._gate(ode, ex, batch_size, step_size, step_size)
        spec, self.J, self.inv = gate
        self.tab = stp._tableau_static()
        dims = [int(w.shape[1]) for w in spec["Ws"]]
        if not fused_train_loop_fits(batch_size, ex.nx, dims,
                                     stages=len(self.tab[2])):
            raise SystemExit("--fused_loop: the configuration exceeds the "
                             "loop kernel's shared-memory budget")
        # the step size as the fp32 solve carries it
        self.dt = float(torch.tensor(step_size,
                                     dtype=next(ex.parameters()).dtype))
        self._init_state(spec)

    @staticmethod
    def _gate(ode, ex, batch_size, step_size, dt0):
        """(prepared stepper, fused gate (spec, J, inv)) of the loop
        kernels."""
        import torch

        p = next(ex.parameters())
        y_tmpl = torch.zeros(batch_size, ex.nx, dtype=p.dtype, device=p.device)
        params = ({}, dict(ex.named_parameters()))
        stp = ode._stepper.prepare(0.0, y_tmpl, params, dt0=dt0)
        gate = stp._fused_reverse_args(params, dt=step_size)
        if gate is None:
            raise SystemExit(
                "--fused_loop requires the fused-kernel gate: --use_fused, "
                "--fixed_jacobian, --linear_solver hpddm, -snes_type ksponly "
                "(frozen linear implicit part)")
        return stp, gate

    def _init_state(self, spec):
        """The weights and zero Adam moments the calls carry."""
        import torch

        self.spec = spec
        self.Ws = [w.detach().clone() for w in spec["Ws"]]
        self.bs = [b.detach().clone() for b in spec["bs"]]
        zeros = lambda ts: [torch.zeros_like(t) for t in ts]  # noqa: E731
        self.m = (zeros(self.Ws), zeros(self.bs))
        self.v = (zeros(self.Ws), zeros(self.bs))
        self.t = 0

    def run(self, y_stack, tgt_stack, lr, eps=1e-8):
        """K = len(y_stack) Adam iterations; returns the K losses."""
        from pnode_tpu_torch.ops.fused_train_loop import fused_train_loop

        self.Ws, self.bs, self.m, self.v, losses = fused_train_loop(
            self.tab, self.dt, y_stack, tgt_stack, self.J, self.inv, self.Ws,
            self.bs, self.m, self.v, self.t,
            activation=self.spec["activation"], sign=self.spec["sign"],
            lr=lr, eps=eps)
        self.t += int(y_stack.shape[0])
        return losses

    def copy_to(self, ex):
        """Write the loop's weights into the model's parameters."""
        import torch

        new = self.spec["rebuild"](self.Ws, self.bs)
        with torch.no_grad():
            for name, prm in ex.named_parameters():
                prm.copy_(new[name])


class FusedAdaptiveLoop(FusedLoop):
    """The ``--fused_loop`` path under ``-ts_adapt_type basic``: K5's
    operands from the fused step gate and the spectral basis of the frozen
    J, the controller's options from the solver, and the weights, Adam
    moments and the dt warm start carried from call to call (bench.py's
    protocol for this workload: the first accepted dt of a call's last
    iteration starts the next call)."""

    def __init__(self, ode, ex, batch_size, step_size):
        from pnode_tpu_torch.ops.fused_adaptive_loop import (
            fused_adaptive_loop_fits)

        stp, gate = self._gate(ode, ex, batch_size, step_size, None)
        spec, self.J = gate[0], gate[1]
        basis = stp._spectral_stage_basis(self.J)
        if basis is None or stp._bIe is None:
            raise SystemExit("--fused_loop -ts_adapt_type basic needs a "
                             "symmetric frozen J and a tableau with an "
                             "embedded pair")
        self.lam, self.Q = basis
        self.cfg, _ = ode._build_adapt_cfg()
        if self.cfg.controller != "basic":
            raise SystemExit("--fused_loop runs the basic controller; "
                             "-ts_adapt_type pi trains per step")
        self.tab = stp._tableau_static() + (stp._bIe, stp._bEe)
        self.gamma = next(float(x) for x in np.diag(stp.tab.a_im) if x != 0)
        self.order = stp.tab.order
        # the trial axis: -ts_adapt_max_steps, 32 for this workload
        self.max_trials = min(ode.max_steps,
                              ode.opts.get_int("ts_adapt_max_steps", 32))
        dims = [int(w.shape[1]) for w in spec["Ws"]]
        if not fused_adaptive_loop_fits(batch_size, ex.nx, dims,
                                        self.max_trials,
                                        stages=len(self.tab[2])):
            raise SystemExit("--fused_loop: the configuration exceeds the "
                             "adaptive loop kernel's shared-memory budget")
        # the window is one step of the data, [0, step_size]; the first
        # call starts cold from dt = step_size
        self.t_end = self.dt = float(step_size)
        self.stats = None
        self._init_state(spec)

    def run(self, y_stack, tgt_stack, lr, eps=1e-8):
        """K = len(y_stack) adaptive Adam iterations; returns the K losses
        (the per-iteration controller stats in ``self.stats``)."""
        from pnode_tpu_torch.ops.fused_adaptive_loop import (
            fused_adaptive_train_loop)

        c = self.cfg
        self.Ws, self.bs, self.m, self.v, losses, self.stats = \
            fused_adaptive_train_loop(
                self.tab, self.gamma, self.lam, self.Q, self.J, self.t_end,
                self.dt, y_stack, tgt_stack, self.Ws, self.bs, self.m,
                self.v, self.t, self.max_trials, rtol=c.rtol, atol=c.atol,
                safety=c.safety, dt_min_factor=c.dt_min_factor,
                dt_max_factor=c.dt_max_factor, order=self.order,
                activation=self.spec["activation"], sign=self.spec["sign"],
                lr=lr, eps=eps)
        if not bool((self.stats["completed"] == 1.0).all()):
            raise SystemExit(
                f"--fused_loop: an iteration ran out of its {self.max_trials} "
                "trials before its window landed (raise -ts_adapt_max_steps)")
        self.dt = self.stats["dt_first"][-1]
        self.t += int(y_stack.shape[0])
        return losses


def make_batches(u, rng, W, batch_size, endpoint):
    """Windowed minibatches: y0 = u[i], targets u[i+1..i+W] (or endpoint)."""
    starts = np.arange(len(u) - W)
    rng.shuffle(starts)
    for b in range(len(starts) // batch_size):
        s = starts[b * batch_size:(b + 1) * batch_size]
        tgt = (u[s + W][:, None] if endpoint
               else np.stack([u[s + 1 + j] for j in range(W)], axis=1))
        yield u[s], tgt


def main(argv=None):
    args, unknown = parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import pnode_tpu_torch as pt
    from pnode_tpu_torch.data import WindowedLoader, generate_ks_data
    from pnode_tpu_torch.models import (
        IMEXSum, KSFuncEX, KSFuncIM, KSMLPFunc, KSSnodeFunc)
    from pnode_tpu_torch.utils import load_checkpoint, save_checkpoint

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass "
                         "--device cpu to run on the CPU)")
    if args.node and args.fused_loop:
        raise SystemExit("--fused_loop runs the discrete adjoint's fused "
                         "kernels; --node differentiates through dopri5: "
                         "drop one of the two flags")
    if args.dp and args.fused_loop:
        raise SystemExit("--dp composes with the per-step training path; "
                         "--fused_loop is a single-card kernel: drop one of "
                         "the two flags")
    if args.dp > 0 and args.batch_size % args.dp:
        raise SystemExit(f"--dp {args.dp} must divide --batch_size "
                         f"{args.batch_size}")
    device = torch.device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh, own_group = (start_dp(args.dp, args.batch_size, device) if args.dp
                       else (None, False))
    dtype = torch.float64 if args.double_prec else torch.float32
    if args.pnode_model == "imex" and args.fixed_jacobian:
        pt.set_option("snes_type", "ksponly")
    pt.init([sys.argv[0]] + unknown)

    u_all, dt_data = generate_ks_data(
        nx=NX, L=L, n_samples=args.data_size, dt_data=args.step_size,
        cache_dir=os.path.join(args.train_dir, "data"))
    if args.normalize == "minmax":
        lo, hi = u_all.min(), u_all.max()
        u_all = 2 * (u_all - lo) / (hi - lo) - 1
    elif args.normalize == "mean":
        u_all = (u_all - u_all.mean()) / u_all.std()
    n_train = int(0.8 * len(u_all))
    u_train, u_val = u_all[:n_train], u_all[n_train:]
    print(f"KS data: train {u_train.shape}, val {u_val.shape}, dt {dt_data}")

    W = args.time_window_size
    t_out = (np.asarray([0.0, W * dt_data]) if args.time_window_endpoint
             else np.arange(W + 1) * dt_data)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    y_tmpl = torch.zeros(args.batch_size, NX, dtype=dtype, device=device)
    ode = pt.ODESolver()
    if args.pnode_model == "imex":
        im = KSFuncIM(nx=NX, L=L, dtype=dtype, device=device,
                      use_fused=args.use_fused)
        ex = KSFuncEX(nx=NX, use_fused=args.use_fused, generator=gen,
                      dtype=dtype, device=device)
        if args.node:
            # the autodiff baseline integrates the combined right-hand side
            # explicitly (differentiating through implicit Newton solves is
            # the discrete adjoint's job, not plain autodiff's)
            ode.setupTS(y_tmpl, pt.TorchFunc(IMEXSum(im, ex)),
                        step_size=args.step_size / 100, method="dopri5",
                        enable_adjoint=False)
        else:
            ode.setupTS(
                y_tmpl, pt.TorchFunc(im), step_size=args.step_size,
                method="imex", imex_form=True, implicit_form=True,
                func2=pt.TorchFunc(ex), linear_solver=args.linear_solver,
                fixed_jacobian=args.fixed_jacobian,
                batch_size=args.batch_size)
    else:
        # the trained module keeps the name ex below
        ex = (KSSnodeFunc(nx=NX, L=L, generator=gen, dtype=dtype,
                          device=device, use_fused=args.use_fused)
              if args.pnode_model == "snode"
              else KSMLPFunc(nx=NX, generator=gen, dtype=dtype,
                             device=device))
        ode.setupTS(
            y_tmpl, pt.TorchFunc(ex), step_size=args.step_size,
            method=args.pnode_method,
            implicit_form=(args.implicit_form
                           or args.pnode_method in ("cn", "beuler")),
            linear_solver=args.linear_solver,
            fixed_jacobian=args.fixed_jacobian, batch_size=args.batch_size)

    def predict(y0):
        """The solve whose gradients train: the discrete adjoint, or under
        --node autograd through the steps."""
        if args.node:
            return ode.solve(y0, t_out, with_adjoint=False)[0]
        return ode.odeint_adjoint(y0, t_out)
    vg = None
    if mesh is not None:
        from pnode_tpu_torch.parallel import (
            dp_value_and_grad, replicate, shard_batch)

        with torch.no_grad():
            for p, r in zip(ex.parameters(),
                            replicate(list(ex.parameters()), mesh)):
                p.copy_(r)
        # each rank solves its shard; the loss reads the live parameters
        vg = dp_value_and_grad(
            lambda params, batch: data_loss(predict(batch[0]), batch[1]),
            mesh)
    opt = torch.optim.Adam(ex.parameters(), lr=args.lr)
    start_epoch, best_val = 0, float("inf")
    ckpt_path = os.path.join(args.train_dir, f"best_{args.pnode_model}.ckpt")
    if args.hotstart and os.path.exists(ckpt_path):
        ck = load_checkpoint(ckpt_path)
        if ck.get("normalize") != args.normalize:
            raise RuntimeError(
                "checkpoint normalization mismatch: the checkpoint is "
                f"{ck.get('normalize')!r}, the run {args.normalize!r}")
        ex.load_state_dict({k: torch.as_tensor(v)
                            for k, v in ck["params"].items()})
        start_epoch, best_val = int(ck["epoch"]) + 1, float(ck["best_val"])
        print(f"hotstart from epoch {start_epoch} (best val {best_val:.6e})")
    # one rank writes the checkpoint
    writes = mesh is None or torch.distributed.get_rank() == 0
    fused = None
    if args.fused_loop:
        if args.pnode_model != "imex":
            raise SystemExit("--fused_loop runs the imex model "
                             "(--pnode_model imex)")
        if W != 1 or dtype != torch.float32:
            raise SystemExit("--fused_loop requires --time_window_size 1 "
                             "and fp32 (no --double_prec)")
        if ode.adapt_type in (None, "none"):
            fused = FusedLoop(ode, ex, args.batch_size, args.step_size)
        else:
            fused = FusedAdaptiveLoop(ode, ex, args.batch_size,
                                      args.step_size)

    def as_t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def data_loss(pred, tgt):
        # pred[0] is y0 itself; targets align with pred[1:]
        return torch.mean((pred[1:].transpose(0, 1) - tgt) ** 2)

    # plateau LR decay on the per-epoch validation loss (halve after 10
    # non-improving validations), as examples/ks.py does
    lr_now, lr_best, lr_bad = args.lr, float("inf"), 0
    # the native windowed loader, examples/ks.py's (the same batches)
    train_loader = WindowedLoader(u_train, window=W, batch=args.batch_size,
                                  seed=args.seed,
                                  endpoint_only=args.time_window_endpoint)
    history = []  # per epoch, the per-iteration train losses
    for epoch in range(start_epoch, args.max_epochs):
        t0 = time.time()
        batches = list(train_loader)
        if fused is not None and batches:
            # the whole epoch as one call; targets (B, 1, d) -> (B, d)
            losses = fused.run(as_t(np.stack([b[0] for b in batches])),
                               as_t(np.stack([b[1][:, 0] for b in batches])),
                               lr_now)
            fused.copy_to(ex)
        else:
            losses = []
            for y0, tgt in batches:
                if vg is not None:
                    # every rank drew the same global minibatch
                    params = list(ex.parameters())
                    loss, grads = vg(params, shard_batch(
                        (as_t(y0), as_t(tgt)), mesh))
                    for p, g in zip(params, grads):
                        p.grad = g
                else:
                    loss = data_loss(predict(as_t(y0)), as_t(tgt))
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                opt.step()
                losses.append(loss.detach())
            losses = torch.stack(losses) if losses else torch.zeros(0)
        history.append(losses.cpu().tolist())
        train_loss = (float(np.mean(history[-1])) if history[-1]
                      else float("nan"))
        if epoch % args.validate_freq:
            continue
        # one full validation batch, like the reference's loader
        with torch.no_grad():
            vb = list(make_batches(u_val, np.random.default_rng(0), W,
                                   len(u_val) - W, args.time_window_endpoint))
            vl = float(np.mean([
                float(data_loss(ode.odeint(as_t(y0), t_out), as_t(tgt)))
                for y0, tgt in vb])) if vb else float("nan")
        if vl < lr_best * (1.0 - 1e-4):
            lr_best, lr_bad = vl, 0
        else:
            lr_bad += 1
            if lr_bad > 10:
                lr_now, lr_bad = lr_now * 0.5, 0
                for group in opt.param_groups:
                    group["lr"] = lr_now
                print(f"plateau: lr -> {lr_now:.2e}")
        print(f"Epoch {epoch:04d} | Time {time.time() - t0:.2f}s | "
              f"Train {train_loss:.6e} | Val {vl:.6e} | "
              f"NFE-F {ode.nfe_forward}")
        if vl < best_val:
            best_val = vl
            if writes:
                save_checkpoint(ckpt_path, {
                    "epoch": epoch, "params": ex.state_dict(),
                    "best_val": best_val, "normalize": args.normalize})
    train_loader.close()
    if own_group:
        torch.distributed.destroy_process_group()
    return best_val, history


if __name__ == "__main__":
    bv, _ = main()
    print(f"best val loss {bv:.6e}")
