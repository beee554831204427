"""Which collectives `torch.distributed`'s gloo backend takes on CUDA tensors.

Starts WORLD (default 2) processes on the machine's first card, joined by a
file store in a temporary directory, and tries on CUDA tensors, one after
the other: all_reduce with SUM, MIN and MAX (float32, float64, int64,
uint8), a bool all_reduce, broadcast, all_gather and send/recv. A rank
announces each collective before it runs it. A collective that kills the
processes (gloo aborts on some) is reported as such, and a new group goes on
with the next one. Prints one JSON line per collective, {"op", "ok",
"error"}, after the card's name and power limit.

    python3 scripts/gloo_cuda_probe.py [WORLD]

The port's sharded paths (`spateo_tpu_torch/parallel/_collectives.py`) use
all_reduce and broadcast only; this says what else would work.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile

DTYPES = ("float32", "float64", "int64", "uint8")
OPS = [f"all_reduce {op} {dt}" for dt in DTYPES for op in ("SUM", "MIN", "MAX")] + [
    "all_reduce MAX bool", "broadcast float32", "all_gather float32", "send/recv float32"]


def run_op(name: str, rank: int, world: int) -> bool:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    kind, *rest = name.split()
    if kind == "all_reduce":
        op, dt = rest
        if dt == "bool":
            t = torch.tensor([rank == 0, True], device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            return bool(t.all())
        expect = {"SUM": sum(range(1, world + 1)), "MIN": 1, "MAX": world}[op]
        t = torch.full((1000,), rank + 1, dtype=getattr(torch, dt), device=dev)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        return bool((t == expect).all())
    if kind == "broadcast":
        t = torch.full((1000,), float(rank), device=dev)
        dist.broadcast(t, src=0)
        return bool((t == 0).all())
    if kind == "all_gather":
        outs = [torch.empty(10, device=dev) for _ in range(world)]
        dist.all_gather(outs, torch.full((10,), float(rank), device=dev))
        return all(bool((o == r).all()) for r, o in enumerate(outs))
    t = torch.full((10,), float(rank), device=dev)  # send/recv
    if rank == 0:
        dist.send(t, dst=1)
    elif rank == 1:
        dist.recv(t, src=0)
    return rank != 1 or bool((t == 0).all())


def rank_main(rank: int, world: int, store: str, start: int) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    for name in OPS[start:]:
        if rank == 0:
            print(json.dumps({"trying": name}), flush=True)
        try:
            ok, error = run_op(name, rank, world), None
            torch.cuda.synchronize()
        except Exception as e:  # the probe's point: report what raises
            ok, error = False, f"{type(e).__name__}: {str(e)[:200]}"
        if rank == 0:
            print(json.dumps({"op": name, "ok": ok, "error": error if error or ok else "wrong result"}), flush=True)
        dist.barrier()
    dist.destroy_process_group()


def main(argv) -> int:
    if argv and argv[0] == "--rank":
        rank_main(int(argv[1]), int(argv[2]), argv[3], int(argv[4]))
        return 0
    world = int(argv[0]) if argv else 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    start = 0
    while start < len(OPS):
        with tempfile.TemporaryDirectory() as tmp:
            procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), str(world), f"{tmp}/store",
                                       str(start)], stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL, text=True) for r in range(world)]
            try:
                out, _ = procs[0].communicate(timeout=120)
            except subprocess.TimeoutExpired:
                out = ""
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        done = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
        reported = {d["op"] for d in done if "op" in d}
        for d in done:
            if "op" in d:
                print(json.dumps(d), flush=True)
        tried = [d["trying"] for d in done if "trying" in d]
        if all(op in reported for op in OPS[start:]):
            break
        crashed = next((op for op in tried if op not in reported), OPS[start + len(reported)])
        print(json.dumps({"op": crashed, "ok": False, "error": "the ranks died or hung (gloo aborted)"}), flush=True)
        start = OPS.index(crashed) + 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
