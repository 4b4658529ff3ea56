"""How far AdamW carries fp32 rounding into the losses of
``test_torch_lora.py::test_training_under_remat_accum_and_decay_matches_jax``:
the port's six steps run as that test runs them, once as they are and
then with every gradient element multiplied by 1 +- u (u = 2^-24, the
sign drawn per element and step from a seed) before the optimizer sees
it. Prints, for each of the test's four cases, the largest relative
change of each step's loss over the seeds, and that change in units of
u. The test's 2^-19 bound for two accumulation steps is argued from it.

    JAX_PLATFORMS=cpu python tests/torch_lora_probe.py
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import test_torch_lora as lora_test  # noqa: E402
from torch_parity import build_pair  # noqa: E402
from tony_tpu_torch.models.convert import from_jax_lora  # noqa: E402
from tony_tpu_torch.ops.adamw import FusedAdamW  # noqa: E402
from tony_tpu_torch.train import (Trainer, lora_init,  # noqa: E402
                                  wrap_apply_fn)

U = 2.0 ** -24
CASES = [("off", 1, 0.0), ("nothing", 2, 0.1), ("dots", 1, 0.1),
         ("attn_saved", 2, 0.0)]


def losses(remat: str, accum: int, wd: float, seed: int | None):
    kw = {} if remat == "off" else dict(remat=True, remat_policy=remat)
    _, jparams, tm = build_pair(0, **kw)
    jlora = lora_test._jax_lora(jparams, 4, lora_test.EXAMPLE_TARGETS)
    adapters = lora_init(torch.Generator(), tm, rank=4,
                         targets=lora_test.EXAMPLE_TARGETS)
    trainer = Trainer(adapters, wrap_apply_fn(lora_test._port_apply, tm,
                                              alpha=lora_test.ALPHA),
                      FusedAdamW(1e-2, weight_decay=wd), accum_steps=accum)
    if seed is not None:
        gen = torch.Generator().manual_seed(seed)
        grads = trainer._grads

        def nudged(batch, acc=None):
            loss, gs = grads(batch, acc)
            for g in gs.values():
                sign = torch.randint(0, 2, g.shape, generator=gen) * 2 - 1
                g.mul_(1 + U * sign.float())
            return loss, gs

        trainer._grads = nudged
    state = trainer.init_state(from_jax_lora(lora_test._np(jlora), tm.cfg))
    out = []
    for b in lora_test._batches(6):
        state, m = trainer.step(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        out.append(float(m["loss"]))
    return np.array(out)


def main() -> None:
    for case in CASES:
        base = losses(*case, None)
        moved = np.max([np.abs(losses(*case, s) - base) / np.abs(base)
                        for s in range(6)], axis=0)
        print(f"{case}: per step {np.array2string(moved, precision=3)}; "
              f"largest {moved.max():.3g} = {moved.max() / U:.2f} u")


if __name__ == "__main__":
    main()
