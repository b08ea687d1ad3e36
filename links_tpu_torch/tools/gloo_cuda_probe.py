"""Which collectives gloo carries for CUDA tensors: two gloo ranks on one
device run each collective once, each pair in processes of its own (a
refused point-to-point send can abort its process), and the result is
checked on the host.

    python -m links_tpu_torch.tools.gloo_cuda_probe [--device cuda:0]

Prints the versions, then one line per collective: ``carried`` or
``refused`` with the end of each rank's output. ``train/parallel.py``'s
``GLOO_HOST_STAGED`` lists the refused ones that ZeRO, TP and PP use; they
go through host copies.
"""

from __future__ import annotations

import argparse
import socket
import subprocess
import sys

OPS = ("all_reduce", "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor",
       "batch_isend_irecv")


def _rank(rank: int, op: str, port: int, device: str) -> bool:
    """Rank ``rank`` of two: run ``op`` on an 8-element tensor and check it."""
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    base = torch.arange(8.0)
    x = (base + 10 * rank).to(dev)
    both = torch.cat([base, base + 10])
    if op == "all_reduce":
        dist.all_reduce(x)
        ok = torch.equal(x.cpu(), 2 * base + 10)
    elif op == "broadcast":
        dist.broadcast(x, src=0)
        ok = torch.equal(x.cpu(), base)
    elif op == "all_gather_into_tensor":
        out = torch.empty(16, device=dev)
        dist.all_gather_into_tensor(out, x)
        ok = torch.equal(out.cpu(), both)
    elif op == "reduce_scatter_tensor":
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, x)
        ok = torch.equal(out.cpu(), (2 * base + 10)[4 * rank:4 * rank + 4])
    else:
        y = torch.empty_like(x)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                           dist.P2POp(dist.irecv, y, 1 - rank)]):
            req.wait()
        ok = torch.equal(y.cpu(), base + 10 * (1 - rank))
    dist.destroy_process_group()
    return ok


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--rank", nargs=3, metavar=("RANK", "OP", "PORT"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        rank, op, port = args.rank
        print(f"ok={_rank(int(rank), op, int(port), args.device)}", flush=True)
        return 0
    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, device {args.device}", flush=True)
    for op in OPS:
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, "-m", "links_tpu_torch.tools.gloo_cuda_probe",
                                   "--device", args.device, "--rank", str(r), op, str(port)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                out = p.communicate()[0] + "\ntimed out"
            outs.append((p.returncode, out))
        carried = all(rc == 0 and "ok=True" in out for rc, out in outs)
        print(f"{op}: {'carried' if carried else 'refused'}", flush=True)
        if not carried:
            for rc, out in outs:
                tail = " | ".join(line for line in out.strip().splitlines()[-2:])
                print(f"    exit {rc}: {tail[:400]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
