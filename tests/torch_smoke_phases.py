"""Run some phases of a checkout's ``chip_smoke.py`` on the card and
print each one's seconds: how the smoke's clock is measured phase by
phase, and how two commits' phases are compared within one call (unpack
the other commit with ``git archive`` into a directory ``.gitignore``
lists and run this once for each tree).

    python3 tests/torch_smoke_phases.py ROOT [PHASE ...]

``ROOT`` is the checkout whose ``chip_smoke.py`` and ``tony_tpu_torch``
run; each ``PHASE`` names a ``phase_*`` function of it (default: the
phases the smoke's clock cut in depth, and what they read: ``build
serve serving_options unpaged_mistral gateway sampled fabric``). A
phase that fails prints its traceback and the rest still run. The last
line is ``PHASES <root> {name: seconds}``. Needs a CUDA device.
"""

import json
import math
import os
import sys
import time
import traceback

DEFAULT = ("build", "serve", "serving_options", "unpaged_mistral",
           "gateway", "sampled", "fabric")


def main(argv) -> int:
    root = os.path.abspath(argv[0])
    names = argv[1:] or DEFAULT
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # what the later phases read of the ones not run here
    ctx = {"card": chip_smoke.card(), "launches": 0,
           "int8_generate": {"bf16": {"replayed": {"tok_s": math.nan}}},
           "flush": torch.empty(64 << 20, dtype=torch.uint8,
                                device="cuda")}
    times = {}
    for name in names:
        t0 = time.perf_counter()
        try:
            getattr(chip_smoke, "phase_" + name)(ctx)
        except Exception:  # noqa: BLE001 — report the phase, run the rest
            traceback.print_exc()
            print(f"phase {name} FAILED", flush=True)
        times[name] = round(time.perf_counter() - t0, 1)
        print(f"  ({name}: {times[name]} s)", flush=True)
    print("PHASES", argv[0], json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
