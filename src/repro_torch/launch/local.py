"""Several ranks on one host without ``torchrun``: :func:`run_local`
starts ``world`` processes (start method ``spawn``), joins them into one
process group over a file store, runs a function in each and returns each
rank's result.  The CPU tests run the mesh paths on gloo ranks this way,
and ``chip_smoke.py`` its two ranks on one card."""
from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional


def _entry(rank: int, world: int, backend: str, store: str, out_dir: str,
           threads: Optional[int]) -> None:
    import torch
    import torch.distributed as dist
    with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ.setdefault("LOCAL_WORLD_SIZE", str(world))
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_local(fn: Callable, world: int, *args: Any, backend: str = "gloo",
              threads: Optional[int] = 1, timeout: float = 600.0,
              work_dir: Optional[str] = None) -> List[Any]:
    """``fn(*args)`` on ``world`` local ranks of one process group
    (``backend``: ``"gloo"`` for CPU ranks, ``"nccl"`` for one card a rank,
    ``"cpu:gloo,cuda:gloo"`` for several ranks on one card).  ``fn`` must
    be importable by name (a module-level function) and return something
    picklable; each rank runs ``threads`` intra-op threads.  Returns the
    results in rank order; raises if a rank raised, or ``TimeoutError``
    (every rank stopped) past ``timeout`` seconds."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=work_dir) as tmp:
        store = os.path.join(tmp, "store")
        # the call goes through a file: arguments past a pipe's buffer
        # would hold the parent until each child has started, one by one
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(
            _entry, args=(world, backend, store, tmp, threads),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
