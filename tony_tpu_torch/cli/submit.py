"""``tony-tpu submit`` — ClusterSubmitter equivalent.

The PyTorch port's copy of ``tony_tpu/cli/submit.py``.

Reference: tony-cli ClusterSubmitter.java:49-95 + the common CLI options
(util/Utils.getCommonOptions :277, TonyClient extras :425-436): --src_dir,
--executes, --task_params, --conf_file, repeated --conf k=v, --python_venv.
A shutdown hook force-kills the running app on Ctrl-C (ref: :92-94).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

from tony_tpu_torch import constants as C
from tony_tpu_torch.client import TonyClient
from tony_tpu_torch.config import build_conf


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tony-tpu submit",
        description="Submit a distributed training job to tony-tpu",
    )
    p.add_argument("--src_dir", help="user source directory shipped to tasks")
    p.add_argument("--executes", help="training entrypoint (script or command)")
    p.add_argument("--task_params", help="args appended to the entrypoint")
    p.add_argument("--conf_file", help="job conf (.toml or .json)")
    p.add_argument("--conf", action="append", default=[],
                   help="override, k=v (repeatable)")
    p.add_argument("--python_venv", help="venv dir or zip shipped to tasks")
    p.add_argument("--shell_env", help="comma K=V pairs exported to tasks")
    p.add_argument("--framework",
                   help="runtime: jax|tensorflow|pytorch|mxnet|standalone|ray")
    p.add_argument("--app_name", help="display name")
    p.add_argument("--instances", type=int,
                   help="shortcut for --conf tony.worker.instances=N")
    return p


def conf_from_args(args: argparse.Namespace):
    conf = build_conf(args.conf_file, args.conf)
    if args.src_dir:
        conf.set("tony.application.src-dir", args.src_dir)
    if args.executes:
        conf.set("tony.application.executes", args.executes)
    if args.task_params:
        conf.set("tony.application.task-params", args.task_params)
    if args.python_venv:
        conf.set("tony.application.python-venv", args.python_venv)
    if args.shell_env:
        conf.set("tony.application.shell-env", args.shell_env)
    if args.framework:
        conf.set("tony.application.framework", args.framework)
    if args.app_name:
        conf.set("tony.application.name", args.app_name)
    if args.instances is not None:
        conf.set("tony.worker.instances", args.instances)
    return conf


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    client = TonyClient(conf_from_args(args))

    def on_interrupt(signum, frame):
        client.force_kill()
        sys.exit(C.EXIT_FAIL)

    signal.signal(signal.SIGINT, on_interrupt)
    signal.signal(signal.SIGTERM, on_interrupt)
    ok = client.run()
    return C.EXIT_SUCCESS if ok else C.EXIT_FAIL


if __name__ == "__main__":
    raise SystemExit(main())
