"""Whether NCCL exchanges a tensor with its own rank.

One process forms a one-rank NCCL group (address and port given here) and
runs one ``batch_isend_irecv`` that sends a tensor to rank 0 and receives it
from rank 0, as ``parallel.Mesh.ppermute`` would at one rank if it did not
copy instead.  The exchange runs in a child process under a time limit, so a
hang ends as a result, not as a stuck card.  Prints the card's name and
power limit, then one JSON line.  Run on a machine with one GPU:

    python3 experiments/probe_nccl_self_send_torch.py
"""

import json
import socket
import subprocess
import sys


def child() -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    t = torch.arange(1024, dtype=torch.float32, device="cuda")
    out = torch.zeros_like(t)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, 0), dist.P2POp(dist.irecv, out, 0)])
    for r in reqs:
        r.wait()
    torch.cuda.synchronize()
    print(json.dumps({"received_equal": bool(torch.equal(out, t))}), flush=True)
    dist.destroy_process_group()


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    try:
        res = subprocess.run([sys.executable, __file__, "--child"], capture_output=True, text=True, timeout=90)
    except subprocess.TimeoutExpired:
        print(json.dumps({"self_exchange": "hung: no result within 90 s"}), flush=True)
        return 0
    last = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    if res.returncode == 0 and last.startswith("{"):
        print(json.dumps({"self_exchange": "completed", **json.loads(last)}), flush=True)
    else:
        err = (res.stderr.strip().splitlines() or ["(no output)"])[-1]
        print(json.dumps({"self_exchange": "raised", "rc": res.returncode, "error": err[-300:]}), flush=True)
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:
        child()
    else:
        sys.exit(main())
