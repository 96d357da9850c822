"""How far the bf16 SqueezeNext ODE-net sits from the fp32 one, in the JAX
package and in the port, from the same flax weights: the second witness for
what chip_smoke.py's phase 12(b) gates (the loss, the head's gradient) and
what it only prints (the whole gradient's cosine, the argmax).

    JAX_PLATFORMS=cpu python tests/torch_bf16_witness.py [--width 0.25]
        [--batch 16]

builds SqNxt-23 at ``--width`` (euler, Nt 1) from flax's seed-0 weights,
takes the cross-entropy loss and its gradient on a batch of numpy normals
(seed 0) in five runs (JAX fp32, JAX bf16, the port in fp32, the port's
bf16 module path, the port's bf16 kernel path: the kernels' plain versions
on the CPU) and prints, for pairs of them, the losses, the logits' largest
difference, the argmax agreement, the whole gradient's cosine and each
piece's (conv biases left out: their true gradient is 0).
tests/test_torch_sqnxt_bf16.py imports it.
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pnode_tpu.models.sqnxt import SqueezeNextODE as JSqueezeNextODE  # noqa: E402
from pnode_tpu_torch.convert import sqnxt_state_dict_from_flax  # noqa: E402
from pnode_tpu_torch.models import SqueezeNextODE  # noqa: E402

RUNS = ("jax fp32", "jax bf16", "port fp32", "port bf16 module",
        "port bf16 kernels")
PAIRS = (("jax bf16", "jax fp32"), ("port bf16 module", "port fp32"),
         ("port bf16 kernels", "port bf16 module"),
         ("port bf16 module", "jax bf16"), ("port fp32", "jax fp32"))


def inputs(B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=(B,)))


def jax_model(width, dtype=None):
    return JSqueezeNextODE(width_x=width, method="euler", Nt=1,
                           use_pallas="off", dtype=dtype)


def jax_run(jm, jp, x, y):
    """(loss, logits, gradients as the port's state dict) of JAX's model."""
    def loss(p):
        logits = jm.apply(p, jnp.asarray(x), training=True)
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y))), logits

    (l, logits), g = jax.value_and_grad(loss, has_aux=True)(jp)
    return float(l), np.asarray(logits, np.float64), {
        k: v.double() for k, v in sqnxt_state_dict_from_flax(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   g)).items()}


def port_model(jp, width, dtype=None, use_kernels="off"):
    tm = SqueezeNextODE(width_x=width, method="euler", Nt=1, dtype=dtype,
                        use_kernels=use_kernels)
    tm.load_state_dict(sqnxt_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jp)), strict=True)
    return tm


def port_run(tm, x, y):
    """(loss, logits, gradients) of the port's model."""
    tm.zero_grad(set_to_none=True)
    logits = tm(torch.tensor(x), training=True)
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(y))
    loss.backward()
    return (float(loss.detach()), logits.detach().double().numpy(),
            {k: p.grad.double() for k, p in tm.named_parameters()})


def cosine(ga, gb, keys):
    keys = [k for k in keys if not (".convs." in k and k.endswith("bias"))]
    a = torch.cat([ga[k].reshape(-1) for k in keys])
    b = torch.cat([gb[k].reshape(-1) for k in keys])
    return float(a @ b / (a.norm() * b.norm()))


def compare(ra, rb):
    """The readings of one pair of runs."""
    (la, lga, ga), (lb, lgb, gb) = ra, rb
    keys = sorted(gb)
    pieces = sorted({int(k.split(".")[1]) for k in keys})
    return dict(
        loss=(la, lb),
        logit_diff=float(np.abs(lga - lgb).max()),
        logit_max=float(np.abs(lgb).max()),
        argmax_equal=float((lga.argmax(-1) == lgb.argmax(-1)).mean()),
        cos=cosine(ga, gb, keys),
        piece_cos=[cosine(ga, gb, [k for k in keys
                                   if int(k.split(".")[1]) == p])
                   for p in pieces])


def readings(width=0.25, B=16):
    """{(run a, run b): compare(a, b)} over PAIRS."""
    x, y = inputs(B)
    jm32, jmbf = jax_model(width), jax_model(width, "bf16")
    jp = jm32.init(jax.random.PRNGKey(0), jnp.asarray(x))
    runs = {"jax fp32": jax_run(jm32, jp, x, y),
            "jax bf16": jax_run(jmbf, jp, x, y),
            "port fp32": port_run(port_model(jp, width), x, y),
            "port bf16 module": port_run(port_model(jp, width, "bf16"), x,
                                         y),
            "port bf16 kernels": port_run(port_model(jp, width, "bf16",
                                                     "on"), x, y)}
    return {(a, b): compare(runs[a], runs[b]) for a, b in PAIRS}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    print(f"SqNxt-23 width {args.width}, B {args.batch}, euler, Nt 1, "
          f"flax seed-0 weights, CPU")
    for (a, b), r in readings(args.width, args.batch).items():
        print(f"{a} vs {b}: loss {r['loss'][0]:.6f} vs {r['loss'][1]:.6f}, "
              f"max |logit diff| {r['logit_diff']:.3e} of {r['logit_max']:.3e}"
              f", argmax equal {r['argmax_equal']:.3f}, whole gradient "
              f"cosine {r['cos']:.4f}")
        print("  per piece: " + " ".join(f"{i}:{c:.3f}" for i, c in
                                         enumerate(r["piece_cos"])))


if __name__ == "__main__":
    main()
