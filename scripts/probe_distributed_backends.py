"""Which torch.distributed operations each backend runs on CUDA tensors.

Run on a machine with one card: `python3 scripts/probe_distributed_backends.py`.
It tries every operation that `flink_ml_tpu_torch.parallel.collectives`
issues on CUDA tensors and checks each result against its definition:
(a) each operation in a world of its own of two gloo ranks that share
card 0 (a backend that cannot run an operation may abort the process, so
one world an operation keeps the others' answers), and all_reduce at four
ranks; (b) every operation in a one-rank NCCL world; then (c) two NCCL
ranks on the same card, which NCCL is expected to refuse.
It prints one JSON line per world and exits 0 whatever the backends
support: the table it prints is what the gloo branch of `collectives.py`
stages through host memory.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _ops(rank: int, world: int, device):
    x = torch.arange(8, dtype=torch.float32, device=device) + rank
    want_sum = sum(torch.arange(8, dtype=torch.float32) + r for r in range(world))

    def all_reduce():
        t = x.clone()
        dist.all_reduce(t)
        return torch.equal(t.cpu(), want_sum)

    def all_reduce_max():
        t = x.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return torch.equal(t.cpu(), torch.arange(8, dtype=torch.float32) + world - 1)

    def broadcast():
        t = x.clone()
        dist.broadcast(t, 0)
        return torch.equal(t.cpu(), torch.arange(8, dtype=torch.float32))

    def all_gather_into_tensor():
        out = torch.empty(8 * world, device=device)
        dist.all_gather_into_tensor(out, x.clone())
        want = torch.cat([torch.arange(8, dtype=torch.float32) + r for r in range(world)])
        return torch.equal(out.cpu(), want)

    def all_gather_list():
        outs = [torch.empty(8, device=device) for _ in range(world)]
        dist.all_gather(outs, x.clone())
        return all(torch.equal(o.cpu(), torch.arange(8, dtype=torch.float32) + r)
                   for r, o in enumerate(outs))

    def reduce_scatter_tensor():
        out = torch.empty(8 // world, device=device)
        dist.reduce_scatter_tensor(out, x.clone())
        return torch.equal(out.cpu(), want_sum.view(world, -1)[rank])

    def p2p_ring():
        recv = torch.empty(8, device=device)
        ops = [dist.P2POp(dist.isend, x.clone(), (rank + 1) % world),
               dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return torch.equal(recv.cpu(), torch.arange(8, dtype=torch.float32) + (rank - 1) % world)

    def all_gather_object():
        out = [None] * world
        dist.all_gather_object(out, ("rank", rank))
        return out == [("rank", r) for r in range(world)]

    def async_all_reduce():
        t = x.clone()
        work = dist.all_reduce(t, async_op=True)
        work.wait()
        return torch.equal(t.cpu(), want_sum)

    def staged_all_reduce():
        """The gloo branch's staging: a pinned host copy, reduced, copied back."""
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        dist.all_reduce(host)
        t = torch.empty_like(x)
        t.copy_(host, non_blocking=True)
        return torch.equal(t.cpu(), want_sum)

    return [(f.__name__, f) for f in (all_reduce, all_reduce_max, broadcast, all_gather_into_tensor,
                                      all_gather_list, reduce_scatter_tensor, p2p_ring,
                                      all_gather_object, async_all_reduce, staged_all_reduce)]


def _rank(rank, world, backend, init, queue, only=None):
    torch.set_num_threads(1)
    out = {"rank": rank}
    try:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        kwargs = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=30), **kwargs)
        for name, fn in _ops(rank, world, device):
            if only is not None and name != only:
                continue
            try:
                ok = fn()
                torch.cuda.synchronize()
                out[name] = "ok" if ok else "wrong result"
            except Exception as exc:  # the table records what the backend refuses
                out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
        dist.destroy_process_group()
    except Exception as exc:
        out["error"] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        out["trace"] = traceback.format_exc()[-600:]
    queue.put(out)


def _world(backend: str, world: int, timeout: float, only=None):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank, args=(r, world, backend, init, queue, only))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        results = []
        deadline = time.monotonic() + timeout
        try:
            for _ in range(world):
                results.append(queue.get(timeout=max(1.0, deadline - time.monotonic())))
        except Exception as exc:
            results.append({"error": f"no result within {timeout} s: {type(exc).__name__}"})
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        return {"backend": backend, "world": world, "op": only or "all",
                "seconds": time.perf_counter() - t0,
                "exitcodes": [p.exitcode for p in procs],
                "results": sorted(results, key=lambda r: r.get("rank", -1))}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0],
                      "device": torch.cuda.get_device_name(0),
                      "nccl": dist.is_nccl_available()}))
    names = [name for name, _ in _ops(0, 2, torch.device("cpu"))]
    for name in names:
        print(json.dumps(_world("gloo", 2, 30.0, only=name)), flush=True)
    print(json.dumps(_world("gloo", 4, 30.0, only="all_reduce")), flush=True)
    for backend, world in (("nccl", 1), ("nccl", 2)):
        print(json.dumps(_world(backend, world, 60.0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
