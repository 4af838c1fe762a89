"""Which ``torch.distributed`` operations take CUDA tensors when two ranks
share one card: gloo's broadcast, all_reduce (MAX), all_gather, send/recv
and gather on ``cuda:0`` tensors, each checked for the right values, and
what NCCL does when both ranks name ``cuda:0``.

The mesh (``cvvae_tpu_torch/parallel``) runs its ranks on one card over
gloo where the machine has one card; its exchange code stages through
pinned host memory exactly the operations this probe finds refused or
wrong.  Each probe runs in its own pair of processes with a short
timeout, so a refused or crashing operation cannot hang the other rank
for long.

    python -m cvvae_tpu_torch.utils.probe_collectives [--device cuda:0]

Prints one line a probe and, last, a JSON object of the findings.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import os
import socket
import tempfile
import time
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(op, backend, device, init, rank, out_path):
    import torch
    import torch.distributed as dist

    result = {"rank": rank}
    try:
        dist.init_process_group(backend, init_method=init, world_size=2,
                                rank=rank,
                                timeout=datetime.timedelta(seconds=40))
        dev = torch.device(device)
        t = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
        t0 = time.perf_counter()
        if op == "broadcast":
            dist.broadcast(t, src=0)
            ok = torch.equal(t.cpu(), torch.arange(4.0))
        elif op == "all_reduce_max":
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            ok = torch.equal(t.cpu(), torch.arange(4.0) + 10)
        elif op == "all_gather":
            out = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(out, t)
            ok = all(torch.equal(o.cpu(), torch.arange(4.0) + 10 * r)
                     for r, o in enumerate(out))
        elif op == "send_recv":
            if rank == 0:
                dist.send(t, dst=1)
                ok = True
            else:
                dist.recv(t, src=0)
                ok = torch.equal(t.cpu(), torch.arange(4.0))
        elif op == "gather":
            out = [torch.empty_like(t) for _ in range(2)] if rank == 0 \
                else None
            dist.gather(t, out, dst=0)
            ok = rank != 0 or all(
                torch.equal(o.cpu(), torch.arange(4.0) + 10 * r)
                for r, o in enumerate(out))
        else:
            raise ValueError(op)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        result.update(accepted=True, right=bool(ok),
                      ms=(time.perf_counter() - t0) * 1e3)
        dist.destroy_process_group()
    except Exception as e:  # the probe's finding, recorded and reported
        result.update(accepted=False, error=f"{type(e).__name__}: "
                      f"{str(e).splitlines()[0][:300]}",
                      trace=traceback.format_exc()[-600:])
    with open(out_path, "w") as f:
        json.dump(result, f)


def probe(op: str, backend: str, device: str, timeout: float = 60.0):
    ctx = multiprocessing.get_context("spawn")
    init = f"tcp://localhost:{_free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{r}.json") for r in range(2)]
        procs = [ctx.Process(target=_rank_main,
                             args=(op, backend, device, init, r, paths[r]))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
        results = []
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join()
                results.append({"rank": r, "accepted": False,
                                "error": f"hung past {timeout}s"})
            elif os.path.exists(paths[r]):
                with open(paths[r]) as f:
                    results.append(json.load(f))
            else:
                results.append({"rank": r, "accepted": False,
                                "error": f"died, exit code {p.exitcode}"})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    findings = {}
    cases = [(op, "gloo") for op in ("broadcast", "all_reduce_max",
                                     "all_gather", "send_recv", "gather")]
    cases.append(("all_reduce_max", "nccl"))
    for op, backend in cases:
        res = probe(op, backend, args.device)
        key = f"{backend}:{op}"
        findings[key] = {
            "accepted": all(r.get("accepted") for r in res),
            "right": all(r.get("right", False) for r in res),
            "errors": sorted({r["error"] for r in res if "error" in r})}
        print(f"[probe] {key} on {args.device} (two ranks): {res}",
              flush=True)
    print(json.dumps(findings), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
