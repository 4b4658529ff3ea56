"""How far the port's ``Trainer`` carries fp32 rounding of the gradients
through three fp32 ``FusedAdamW`` steps, and how far it ends from the JAX
``Trainer`` on the same draw: the measurement behind the parameter bound
of ``tests/test_torch_scan.py::test_trainer_matches_jax`` (ROADMAP.md
section 3, item 4) and ``tests/test_torch_fsdp.py``'s Trainer cases.

For each draw (``build_pair(0)`` and ``build_pair(0, scan_layers=True)``
with ``test_torch_train.py``'s batches, and ``test_torch_fsdp.py``'s wider
draw with its batches) and each ``accum_steps`` (1, 2), the three steps
of ``test_torch_train.py``'s recipe run once as they are, then five times
with every gradient element multiplied by 1 +- u (u = 2^-24, the sign
drawn per element and step from a seed) before the optimizer sees it.
Then five times more with every element of a leaf's gradient moved by
+- delta, delta the largest difference between the two packages'
gradients of that leaf at the first step (measured here). Prints the
largest parameter change either nudge made, the largest
difference from the JAX Trainer's parameters, and where that difference
sits: the leaf and element, and the JAX and port gradients' second
moments there (a near-zero ``nu`` makes Adam's step lr-sized whatever
the gradient's size, so a rounding-sized gradient difference there moves
the parameter by up to 2 lr), and the same two numbers over every leaf
but ``attn.k.bias``, whose gradient is zero in exact arithmetic (a
constant added to every key shifts all of a query's scores alike, which
softmax cancels), so that each step moves it by the sign of rounding
noise times about lr, in either package.

    JAX_PLATFORMS=cpu python tests/torch_trainer_probe.py
"""

import os
import sys

import jax
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (the CPU platform, 8 virtual devices)
import test_torch_train as train_tests  # noqa: E402
from tony_tpu_torch.models.convert import from_jax_params  # noqa: E402
from tony_tpu_torch.ops.adamw import FusedAdamW  # noqa: E402
from tony_tpu_torch.train import Trainer  # noqa: E402

U = 2.0 ** -24
SEEDS = range(5)


def port_run(tm, accum, seed, batches, delta=None):
    """The port's three steps; with ``seed``, every gradient element
    nudged: by a factor 1 +- u, or (``delta``, by leaf) by +- delta."""
    tr = Trainer(tm, train_tests._apply(None), FusedAdamW(train_tests.LR),
                 accum_steps=accum)
    if seed is not None:
        gen = torch.Generator().manual_seed(seed)
        grads = tr._grads

        def nudged(batch, acc=None):
            loss, gs = grads(batch, acc)
            for n, g in gs.items():
                sign = (torch.randint(0, 2, g.shape, generator=gen) * 2
                        - 1).float()
                if delta is None:
                    g.mul_(1 + U * sign)
                else:
                    g.add_(delta[n] * sign)
            return loss, gs

        tr._grads = nudged
    state, _ = train_tests._run_torch(tr, batches, tr.init_state())
    return state


def first_grads_apart(jm, jparams, tm, batch) -> dict:
    """Each leaf's largest difference between the two packages' gradients
    of the first step's loss (the same weights and batch)."""
    import jax.numpy as jnp

    from tony_tpu.ops.xent import chunked_cross_entropy as jax_xent

    def loss(p):
        h = jm.apply(p, jnp.asarray(batch, jnp.int32), return_hidden=True)
        return jax_xent(h[:, :-1], p["params"]["embedding"],
                        jnp.asarray(batch[:, 1:], jnp.int32), chunk_size=40)

    want = from_jax_params(jax.tree.map(
        np.asarray, jax.grad(loss)({"params": jparams})), tm.cfg)
    named = list(tm.named_parameters())
    x = torch.from_numpy(batch)
    got = torch.autograd.grad(train_tests._apply(None)(tm, {"tokens": x}),
                              [p for _, p in named])
    return {n: float((g - want[n]).abs().max())
            for (n, _), g in zip(named, got)}


def draws():
    import test_torch_fsdp as fsdp_tests
    from torch_parity import build_pair

    yield "build_pair(0)", train_tests._pair(), train_tests._batches(3)
    yield "build_pair(0, scan_layers=True)", \
        train_tests._pair(scan_layers=True), train_tests._batches(3)
    yield "test_torch_fsdp's draw", build_pair(0, **fsdp_tests.MESH_KW), \
        fsdp_tests._batches()


def largest(diffs: dict, skip: str = "") -> tuple[float, str, int]:
    best = (0.0, "", 0)
    for n, d in diffs.items():
        if skip and skip in n:
            continue
        if float(d.max()) > best[0]:
            best = (float(d.max()), n, int(d.argmax()))
    return best


def main() -> None:
    for name, (jm, jparams, tm), batches in draws():
        start = {n: t.clone() for n, t in tm.state_dict().items()}
        for accum in (1, 2):
            tm.load_state_dict(start)
            jstate, _ = train_tests._run_jax(
                train_tests._jax_trainer(jm, accum=accum), jparams, batches)
            want = from_jax_params(jax.tree.map(np.asarray, jstate.params),
                                   tm.cfg)
            base = port_run(tm, accum, None, batches)
            # the module's parameters are the masters: keep them apart
            nus = {n: t.clone() for n, t in base.opt_state.nu.items()}
            base = {n: t.clone() for n, t in base.params.items()}
            tm.load_state_dict(start)
            apart = first_grads_apart(jm, jparams, tm, batches[0])
            carry = {}
            for how, delta in (("+-u", None), ("+-delta", apart)):
                carry[how] = {n: torch.zeros_like(p)
                              for n, p in base.items()}
                for s in SEEDS:
                    tm.load_state_dict(start)
                    moved = port_run(tm, accum, s, batches, delta)
                    for n, p in base.items():
                        carry[how][n] = torch.maximum(
                            carry[how][n], (moved.params[n] - p).abs())
            diffs = {n: (p - want[n]).abs() for n, p in base.items()}
            print(f"{name}: the first step's gradients apart by up to "
                  f"{max(apart.values()):.3g} (delta, by leaf)", flush=True)
            for skip in ("", "attn.k.bias"):
                c = {how: largest(t, skip)[0] for how, t in carry.items()}
                d, n, i = largest(diffs, skip)
                nu = float(nus[n].reshape(-1)[i])
                print(f"{name} accum={accum}"
                      + (f" (all but {skip})" if skip else "")
                      + f": nudges moved a param by up to {c['+-u']:.3g} "
                      f"(+-u), {c['+-delta']:.3g} (+-delta); port against "
                      f"JAX {d:.3g} at {n}[{i}] (nu there {nu:.3g}; lr "
                      f"{train_tests.LR})", flush=True)


if __name__ == "__main__":
    main()
