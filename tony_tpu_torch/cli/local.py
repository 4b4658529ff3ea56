"""``tony-tpu local`` — LocalSubmitter equivalent.

The PyTorch port's copy of ``tony_tpu/cli/local.py``.

Reference: tony-cli LocalSubmitter.java: boots a MiniCluster, runs a job
against it with security off, tears down. Here: isolated temp staging +
fast timings, then a normal submission. The job runs on this host's card
unless ``--device cpu`` hides it from the job's processes
(``MiniTonyCluster(device="cpu")``); ``--root DIR`` keeps the staging and
history tree under DIR after the job.
"""

from __future__ import annotations

import logging

from tony_tpu_torch import constants as C
from tony_tpu_torch.cli.submit import build_parser, conf_from_args
from tony_tpu_torch.client import TonyClient
from tony_tpu_torch.mini import MiniTonyCluster


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = build_parser()
    parser.prog = "tony-tpu local"
    parser.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda",
                        help="cpu hides every GPU from the job")
    parser.add_argument("--root",
                        help="keep staging and history under this dir "
                        "(default: a temp dir removed at exit)")
    args = parser.parse_args(argv)
    with MiniTonyCluster(device=args.device, root=args.root) as mini:
        conf = mini.adopt(conf_from_args(args))
        conf.set("tony.application.security.enabled", False)
        ok = TonyClient(conf).run()
    return C.EXIT_SUCCESS if ok else C.EXIT_FAIL


if __name__ == "__main__":
    raise SystemExit(main())
