"""The per-node launcher: one process per card from one pod's env.

    python -m tf_operator_tpu_torch.runtime.launch [--nproc-per-node G] -- COMMAND [ARG ...]

The operator runs one pod per node (``api/gpu.py``) and gives it the env of
one rank: the JAXJob contract (``JAX_NUM_PROCESSES`` = N pods,
``JAX_PROCESS_ID`` = p) or a PyTorchJob's c10d env (``WORLD_SIZE`` = N,
``RANK`` = r). The port runs one process per card, so the launcher starts
COMMAND G times, child l with:

- ``JAX_NUM_PROCESSES`` = N·G and ``JAX_PROCESS_ID`` = p·G + l;
- ``WORLD_SIZE`` = N·G and ``RANK`` = r·G + l, when ``MASTER_ADDR``,
  ``WORLD_SIZE`` and ``RANK`` are set;
- ``LOCAL_RANK`` = l and ``LOCAL_WORLD_SIZE`` = G (``gpu_init`` sets card l);
- the heartbeat env (``TPU_HEARTBEAT_*``) on local rank 0 only: a pod has
  one Lease and one beat file, and G publishers would overwrite each other;
- with the operator's ``TPU_SHARD_SERVER`` on, ``TPU_SHARD_SERVER_PORT`` =
  P + l, where P starts a block of G ports free on the loopback when the
  launcher starts: each rank serves its own shards of a peer restore on
  its port, and the one address the pod publishes, local rank 0's, locates
  them all (``runtime/shard_server.local_peer_addresses``);

and every other variable as the pod has it: the coordinator address (pod
0's, where global rank 0, its local rank 0, serves the rendezvous),
``JAX_NUM_SLICES``/``JAX_SLICE_INDEX`` (a node is a slice) and
``JAX_MESH_SPEC``. A pod env with neither contract is refused.

G defaults to the cards visible (``torch.cuda.device_count()``) and is
refused above them, and when there is none: no rank falls back to the
CPU. A command that asks for the CPU (``--device cpu``) must give G. Under a
slice-local world (``JAX_SLICE_LOCAL_WORLD``) ``gpu_init`` reads the slice's
world from the hosts and these local ranks, not from the global
``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID`` written here: node w of a slice of
N nodes holds its ranks w·G + l of N·G.

The children's output (stdout and stderr) reaches the launcher's stdout a
whole line at a time, so that the G ranks' lines do not interleave in the
pod's log. When a child exits non-zero or is killed, the launcher sends SIGTERM to
the others, SIGKILL to those still running after ``GRACE_SECONDS``, and
exits with that child's code (128 + the signal for a child killed by one,
as a shell reports it), so that the operator's exit-code policy sees 137
and 143 as retryable and any other code as it is. SIGTERM or SIGINT to the
launcher goes on to every child. It exits 0 only when every child did.
The children die with the launcher (Linux's parent-death signal): a
SIGKILL of the launcher alone, which no handler sees, must not leave
orphans that hold the cards, the ports and the slice's checkpoint
stream while the operator starts the pod again.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Mapping, Optional

from . import heartbeat
from .gpu_init import (
    ENV_COORDINATOR_ADDRESS,
    ENV_LOCAL_RANK,
    ENV_LOCAL_WORLD_SIZE,
    ENV_MASTER_ADDR,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    ENV_RANK,
    ENV_WORLD_SIZE,
)

HEARTBEAT_ENV = (heartbeat.ENV_HEARTBEAT_LEASE, heartbeat.ENV_HEARTBEAT_NAMESPACE,
                 heartbeat.ENV_HEARTBEAT_INTERVAL, heartbeat.ENV_HEARTBEAT_FILE)
_TRUTHY = ("1", "true", "yes")
GRACE_SECONDS = 10.0  # after a child fails, the others' time to exit on SIGTERM
POLL_SECONDS = 0.05


def rank_env(env: Mapping[str, str], local_rank: int, nproc: int,
             shard_server_port: Optional[int] = None) -> Dict[str, str]:
    """The env of child ``local_rank`` of ``nproc`` on a node whose pod has
    ``env``; ``shard_server_port`` is the base of the node's block of shard
    server ports, when the pod serves shards."""
    out = dict(env)
    jax = bool(env.get(ENV_COORDINATOR_ADDRESS))
    c10d = all(env.get(k) for k in (ENV_MASTER_ADDR, ENV_WORLD_SIZE, ENV_RANK))
    if not (jax or c10d):
        raise ValueError(
            f"the pod's env has neither the JAXJob contract ({ENV_COORDINATOR_ADDRESS}) nor "
            f"the c10d one ({ENV_MASTER_ADDR}, {ENV_WORLD_SIZE}, {ENV_RANK})")
    if jax:
        out[ENV_NUM_PROCESSES] = str(int(env.get(ENV_NUM_PROCESSES, "1")) * nproc)
        out[ENV_PROCESS_ID] = str(int(env.get(ENV_PROCESS_ID, "0")) * nproc + local_rank)
    if c10d:
        out[ENV_WORLD_SIZE] = str(int(env[ENV_WORLD_SIZE]) * nproc)
        out[ENV_RANK] = str(int(env[ENV_RANK]) * nproc + local_rank)
    out[ENV_LOCAL_RANK] = str(local_rank)
    out[ENV_LOCAL_WORLD_SIZE] = str(nproc)
    if shard_server_port is not None:
        out[heartbeat.ENV_SHARD_SERVER_PORT] = str(shard_server_port + local_rank)
    if local_rank:
        for key in HEARTBEAT_ENV:
            out.pop(key, None)
    return out


def runs_on_cpu(command: List[str]) -> bool:
    """Whether ``command`` asks its entry point for the CPU."""
    return "--device=cpu" in command or any(
        a == "--device" and b == "cpu" for a, b in zip(command, command[1:]))


def processes_per_node(nproc: Optional[int], command: List[str]) -> int:
    """G: ``nproc`` checked against the cards visible, or their count."""
    if runs_on_cpu(command):
        if not nproc:
            raise ValueError("a command on the CPU (--device cpu) needs --nproc-per-node")
        return nproc
    import torch

    visible = torch.cuda.device_count()
    if visible == 0:
        raise ValueError("no card is visible (CUDA is not available); the launcher starts "
                         "one process a card and none on the CPU unless the command asks "
                         "for it (--device cpu)")
    if nproc is None:
        return visible
    if not 1 <= nproc <= visible:
        raise ValueError(f"--nproc-per-node {nproc} with {visible} cards visible")
    return nproc


def free_port_block(n: int, host: str = "127.0.0.1", attempts: int = 64) -> int:
    """The first of ``n`` consecutive ports that bind on ``host`` now (the
    shard servers' host). Another process may still take one before its
    rank's server binds it: that rank then serves nothing
    (``llama_train.recover``), and a peer restoring from it falls to
    storage."""
    for _ in range(attempts):
        socks = []
        try:
            first = socket.socket()
            socks.append(first)
            first.bind((host, 0))
            base = first.getsockname()[1]
            for port in range(base + 1, base + n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind((host, port))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise OSError(f"no block of {n} free ports on {host} in {attempts} tries")


def exit_code(returncode: int) -> int:
    """A child's code as a shell reports it: 128 + the signal that killed it."""
    return 128 - returncode if returncode < 0 else returncode


def _die_with_parent() -> None:
    """In a child, before it runs: SIGKILL it when the launcher dies
    (``prctl(PR_SET_PDEATHSIG)``; nothing where libc has no prctl)."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (AttributeError, OSError):
        pass


def _relay(pipe, fd: int, lock: threading.Lock) -> None:
    """A child's output, one whole line at a time, onto ``fd``."""
    for line in iter(pipe.readline, b""):
        with lock:
            while line:
                line = line[os.write(fd, line):]
    pipe.close()


def launch(command: List[str], nproc: int, env: Optional[Mapping[str, str]] = None) -> int:
    """Run ``command`` as ``nproc`` children of this node (:func:`rank_env`
    of ``env``, by default this process's) until all have exited; the
    launcher's exit code."""
    env = os.environ if env is None else env
    serving = str(env.get(heartbeat.ENV_SHARD_SERVER, "")).lower() in _TRUTHY
    base = free_port_block(nproc) if serving else None
    envs = [rank_env(env, local, nproc, base) for local in range(nproc)]
    children = [subprocess.Popen(command, env=e, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, preexec_fn=_die_with_parent)
                for e in envs]
    lock, fd = threading.Lock(), sys.stdout.fileno()
    relays = [threading.Thread(target=_relay, args=(c.stdout, fd, lock), daemon=True)
              for c in children]
    for relay in relays:
        relay.start()
    stopped: list = []  # the signal that asked the launcher to stop

    def stop_all(sig: int) -> None:
        for child in children:
            if child.poll() is None:
                try:
                    child.send_signal(sig)
                except ProcessLookupError:
                    pass

    def forward(signum, frame) -> None:
        stopped.append(signum)
        stop_all(signum)

    previous = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    failure, deadline = None, None
    try:
        while None in [child.poll() for child in children]:
            if failure is None:
                failed = [c.returncode for c in children if c.returncode not in (None, 0)]
                if failed:
                    failure = exit_code(failed[0])
                    stop_all(signal.SIGTERM)
            if (failure is not None or stopped) and deadline is None:
                deadline = time.monotonic() + GRACE_SECONDS
            if deadline is not None and time.monotonic() > deadline:
                stop_all(signal.SIGKILL)
            time.sleep(POLL_SECONDS)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        for relay in relays:
            relay.join(timeout=GRACE_SECONDS)
    if failure is None:
        failed = [c.returncode for c in children if c.returncode != 0]
        failure = exit_code(failed[0]) if failed else None
    if failure is not None:
        return failure
    return 128 + stopped[0] if stopped else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.runtime.launch",
        description="Run COMMAND once per card of this node, each with its rank's env.")
    parser.add_argument("--nproc-per-node", type=int, default=None,
                        help="processes on this node (default: the cards visible)")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="-- COMMAND [ARG ...]")
    args = parser.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        parser.error("no command given")
    try:
        nproc = processes_per_node(args.nproc_per_node, command)
        rank_env(os.environ, 0, nproc)  # refuse a world the node cannot form
    except ValueError as exc:
        print(f"launch: {exc}", file=sys.stderr)
        return 2
    return launch(command, nproc)


if __name__ == "__main__":
    sys.exit(main())
