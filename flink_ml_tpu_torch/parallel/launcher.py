"""Start the ranks of a world on one machine and run functions on them.

The JAX package drives every device from one process and needs no
launcher; what stands for it there is `mesh.init_distributed`
(`jax.distributed.initialize`). The port runs one process per rank
(parallel/mesh.py), and this module starts R of them on one machine:

- `World(world_size, backend=None, device=None)` spawns R ranks with the
  `spawn` start method of `torch.multiprocessing` (never `fork`: the
  parent may hold a CUDA context). Each rank (`_rank_main`) joins the
  world through a `file://` rendezvous in a fresh temporary directory
  (`mesh.init_distributed`, which applies the backend rule), then runs the
  jobs it is sent, in order, until the world closes. `run(target, *args)`
  runs one job on every rank and returns every rank's result, in rank
  order; `target` is a function or its "module:function" path, and each
  rank imports it by module path, so a target lives in a module the rank
  can import (never a test file that imports JAX). Results and arguments
  cross processes by pickling: pass host values (numpy, floats, dicts).
  A world for one job is `World(R).run(target)[0]`: rank 0's result.

Nothing waits without a bound. Every collective of a rank raises after
`collective_timeout_s` (the process group's timeout), every job after
`timeout_s` (the world is then closed and `TimeoutError` raised), and a
rank's exception comes back with its traceback as a `RankError` (the
other ranks get 5 s more to report, unless every rank still owing a
result is dead; a rank process that dies without a result is an error
too). A world whose rank failed or timed out is closed: it runs no
further job, and it keeps what a supervisor reads of the failure: `deaths` (the ranks that exited on their own with a failure
status, each with its code and when it was seen), `failed_at` (when the
first failure was seen) and `silent` (the ranks that gave no result).
`close()` joins every rank (bounded) and kills one that does not exit.

`World(R, model_shards=m)` lays the world out as the 2D mesh (R / m) x m
(`mesh.create_mesh_2d`): every rank creates every axis sub-group right
after it joins, in one order, and makes that mesh its default; a job then
runs on it without knowing the layout. `model_shards=None` keeps the 1D
`data` mesh.

Each rank runs `torch.set_num_threads(threads)` (default 1), so R ranks on
a shared machine do not oversubscribe its cores, and, with `sanitize`,
enables the runtime sanitizer and records as shard `rank` of the `mesh`
group (`analysis.sanitizer.set_process_shard`).
"""

from __future__ import annotations

import importlib
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from . import mesh as mesh_lib

Target = Union[str, Callable]


class RankError(RuntimeError):
    """A job raised on a rank; the message carries the rank's traceback."""


def target_path(target: Target) -> str:
    """The "module:function" path a rank imports `target` by."""
    if isinstance(target, str):
        if ":" not in target:
            raise ValueError(f"a target path is 'module:function', got {target!r}")
        return target
    module, name = getattr(target, "__module__", None), getattr(target, "__qualname__", "")
    if not module or "<" in name:
        raise ValueError(f"{target!r} is not a module-level function a rank can import")
    return f"{module}:{name}"


def resolve(path: str) -> Callable:
    module, _, name = path.partition(":")
    fn: Any = importlib.import_module(module)
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn


def _rank_main(rank: int, world_size: int, init_method: str, backend: Optional[str],
               device: Optional[str], collective_timeout_s: float, threads: int,
               sanitize: bool, model_shards: Optional[int], jobs, results) -> None:
    """A rank: join the world, then run each job until the None sentinel."""
    torch.set_num_threads(int(threads))
    from .. import config

    scope = config.use_device(device) if device is not None else None
    try:
        if scope is not None:
            scope.__enter__()  # this process's device, for as long as the rank runs
        if sanitize:
            from ..analysis import sanitizer

            sanitizer.enable(register_atexit=False)
            sanitizer.set_process_shard(rank)
        mesh_lib.init_distributed(init_method, world_size=world_size, rank=rank,
                                  backend=backend, device=device,
                                  timeout_s=collective_timeout_s)
        if model_shards is not None:
            mesh_lib.set_default_mesh(mesh_lib.create_mesh_2d(model_shards))
    except BaseException:  # the parent raises it as the world's first failure
        results.put((None, rank, "error", traceback.format_exc()))
        return
    results.put((None, rank, "ok", None))
    import torch.distributed as dist

    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            job_id, path, args = job
            try:
                value = resolve(path)(*args)
                results.put((job_id, rank, "ok", value))
            except BaseException:
                results.put((job_id, rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """R spawned ranks on this machine, each joined to one process group."""

    def __init__(self, world_size: int, backend: Optional[str] = None,
                 device: Optional[str] = None, timeout_s: float = 600.0,
                 collective_timeout_s: float = mesh_lib.DEFAULT_TIMEOUT_S,
                 threads: int = 1, sanitize: bool = False,
                 model_shards: Optional[int] = None):
        self.world_size = int(world_size)
        if model_shards is not None and self.world_size % int(model_shards):
            raise ValueError(f"model_shards={model_shards} does not divide {world_size} ranks")
        self.model_shards = None if model_shards is None else int(model_shards)
        self.timeout_s = float(timeout_s)
        self.broken: Optional[str] = None
        #: rank -> (exit code, wall time first seen) of each rank process that
        #: ended on its own with a failure status, before the world closed it
        self.deaths: Dict[int, Tuple[int, float]] = {}
        #: the wall time (`time.time()`) the failed job's first failure was
        #: seen (a rank's error, a rank's death or the timeout), and the ranks
        #: that gave that job no result
        self.failed_at: Optional[float] = None
        self.silent: List[int] = []
        self._closed = False
        ctx = torch.multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="flink_ml_tpu_torch_world_")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        self._jobs = [ctx.Queue() for _ in range(self.world_size)]
        self._results = ctx.Queue()
        self._next = 0
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, name=f"rank{r}",
                        args=(r, self.world_size, init, backend,
                              None if device is None else str(device),
                              float(collective_timeout_s), threads, sanitize,
                              self.model_shards, self._jobs[r], self._results))
            for r in range(self.world_size)]
        for proc in self._procs:
            proc.start()
        try:
            self._collect(None, self.timeout_s)
        except BaseException:
            self.close()
            raise

    def _collect(self, job_id, timeout_s: float) -> List[Any]:
        """Every rank's result of `job_id`, in rank order; raises on the
        first rank error (after up to 5 s more for the others) or when
        `timeout_s` passes, and closes the world."""
        out: List[Any] = [None] * self.world_size
        seen, errors = set(), {}
        deadline = time.monotonic() + timeout_s
        while len(seen) < self.world_size:
            left = deadline - time.monotonic()
            self._note_deaths()
            if errors and set(range(self.world_size)) - seen <= set(self.deaths):
                break  # every rank still owing a result is dead
            try:
                got_id, rank, status, value = self._results.get(
                    timeout=max(0.05, min(left, 0.25)))
            except queue_mod.Empty:
                if self.deaths and not errors:
                    dead = [self._procs[r].name for r in sorted(self.deaths)]
                    errors[-1] = f"rank process(es) {dead} exited without a result"
                    self.failed_at = min(t for _, t in self.deaths.values())
                if errors or left <= 0:
                    break
                continue
            if got_id != job_id:
                continue
            seen.add(rank)
            if status == "ok":
                out[rank] = value
            else:
                errors[rank] = value
                if self.failed_at is None:
                    self.failed_at = time.time()
                deadline = min(deadline, time.monotonic() + 5.0)
        if errors or len(seen) < self.world_size:
            self._note_deaths()
            if self.failed_at is None:
                self.failed_at = time.time()
            self.silent = sorted(set(range(self.world_size)) - seen)
            self.broken = "a rank failed" if errors else "a job timed out"
            self.close(join_s=5.0)
            if errors:
                first = min(errors)
                raise RankError(f"rank {first} failed:\n{errors[first]}"
                                if first >= 0 else errors[first])
            raise TimeoutError(f"ranks {sorted(set(range(self.world_size)) - seen)} gave no "
                               f"result within {timeout_s} s")
        return out

    def _note_deaths(self) -> None:
        """Record each rank process that has ended on its own with a
        failure status (any nonzero exit code, a signal included) in
        `deaths`."""
        now = time.time()
        for r, proc in enumerate(self._procs):
            if r not in self.deaths and not proc.is_alive() and proc.exitcode not in (0, None):
                self.deaths[r] = (int(proc.exitcode), now)

    def run(self, target: Target, *args, timeout_s: Optional[float] = None) -> List[Any]:
        """Run `target(*args)` on every rank; every rank's result."""
        if self.broken is not None:
            raise RuntimeError(f"this world is closed ({self.broken})")
        path = target_path(target)
        job_id = self._next
        self._next += 1
        for jobs in self._jobs:
            jobs.put((job_id, path, args))
        return self._collect(job_id, self.timeout_s if timeout_s is None else timeout_s)

    def close(self, join_s: float = 30.0) -> None:
        """Stop every rank: the sentinel, a bounded join, then a kill."""
        if self._closed:
            return
        self._closed = True
        for jobs in self._jobs:
            try:
                jobs.put(None)
            except (ValueError, OSError):
                pass
        deadline = time.monotonic() + join_s
        for proc in self._procs:
            proc.join(max(0.1, deadline - time.monotonic()))
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
                proc.join(5.0)
        for q in self._jobs + [self._results]:
            q.close()
            q.join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)
        if self.broken is None:
            self.broken = "closed"

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

