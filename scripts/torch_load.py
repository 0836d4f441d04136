"""Run a command beside processes that load the host's CPU as a pytest
worker running torch in process does: small torch ops in a loop at a
given intra-op thread count.

    python3 scripts/torch_load.py [--procs 6] [--threads 8] -- COMMAND ...

At torch's default of a thread per core (``--threads`` the core count)
each parallel region leaves its OpenMP threads spinning, which starves
the other processes on the host far more than one busy thread does
(``--threads 1``). The loaders start first, the command runs, and the
loaders stop with it; the command's exit code is returned.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

LOADER = r"""
import sys, time, torch
torch.set_num_threads(int(sys.argv[1]))
x = torch.randn(128, 128)
while True:
    for _ in range(50):
        torch.nn.functional.silu(x @ x).sum(0)
    time.sleep(0.001)
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_load")
    parser.add_argument("--procs", type=int, default=6)
    parser.add_argument("--threads", type=int, default=8)
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        parser.error("no command to run")
    loaders = [subprocess.Popen([sys.executable, "-c", LOADER, str(args.threads)])
               for _ in range(args.procs)]
    try:
        time.sleep(3)  # the loaders' imports done, their loops running
        return subprocess.call(command)
    finally:
        for p in loaders:
            p.kill()
        for p in loaders:
            p.wait()


if __name__ == "__main__":
    raise SystemExit(main())
