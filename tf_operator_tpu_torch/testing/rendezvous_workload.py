"""A real ``torch.distributed`` rendezvous workload: the port's twin of
``tf_operator_tpu/testing/rendezvous_workload.py``.

    python -m tf_operator_tpu_torch.testing.rendezvous_workload [--device cpu]

Consumes only the operator-injected env, rendezvouses through
``gpu_init`` (NCCL on the cards, gloo with ``--device cpu``), and proves the
collective fabric: every rank all-reduces its contribution, rank + 1, over
the world, and a one over each axis of the declared mesh. Exits 0 only if
the world's sum is the closed form n (n + 1) / 2 and the product of the
axes' sums is n.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from ..parallel.mesh import mesh_axes
from ..runtime import gpu_init


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rendezvous_workload")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--timeout", type=int, default=60)
    args = parser.parse_args(argv)

    topo = gpu_init.initialize(device=args.device, timeout_seconds=args.timeout)
    print(f"[rendezvous] process_id={topo.process_id} num_processes={topo.num_processes} "
          f"coordinator={topo.coordinator_address}", flush=True)
    if not dist.is_initialized():
        print("[rendezvous] FAIL: no distributed world in the env", flush=True)
        return 3
    try:
        n = dist.get_world_size()
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
        total = torch.tensor([float(dist.get_rank() + 1)], device=device)
        dist.all_reduce(total)
        want = n * (n + 1) / 2
        mesh = gpu_init.global_mesh(topo, device.type)
        product = 1.0
        for axis in mesh.mesh_dim_names:
            one = torch.ones(1, device=device)
            dist.all_reduce(one, group=mesh.get_group(axis))
            product *= one.item()
        print(f"[rendezvous] sum={total.item()} want={want} "
              f"mesh={mesh_axes(mesh)} "
              f"axes_product={product} want={n}", flush=True)
        if total.item() != want or product != n:
            print("[rendezvous] FAIL: collective mismatch", flush=True)
            return 4
    finally:
        dist.destroy_process_group()
    print("[rendezvous] OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
