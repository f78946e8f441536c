"""Start a function on several processes, one rank each.

    results = launch(fn, nprocs, args)                      # nccl, a card a rank
    results = launch(fn, nprocs, args, device="cpu")        # gloo on the CPU

`fn(rank, world, *args)` must be importable (a module-level function of a
package, not of `__main__`): the processes are spawned. Each process joins
a process group from a `file://` store in a fresh temporary directory (so
runs side by side never meet). `device` is "cuda" unless the CPU is asked
for, and raises with no GPU; rank r takes card r modulo the cards. The
backend is `nccl` on CUDA and `gloo` on the CPU; gloo on CUDA tensors (ranks
sharing a card) only when asked for. fn's return values come back in rank
order. With `init=False`, fn starts the group itself (torchrun's
environment, or the trainer's `multihost` start) from the store that
`coordinator()` holds, under the environment `env` adds. A rank that raises
exits non-zero, which stops the others, and the launch raises with every
rank's error; a rank still running after `timeout` seconds prints every
thread's stack and exits.
"""
from __future__ import annotations

import faulthandler
import os
import tempfile
import traceback
from contextlib import contextmanager
from datetime import timedelta
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device


@contextmanager
def coordinator(host: str = "127.0.0.1") -> Iterator[Tuple[int, Dict[str, str]]]:
    """A rendezvous store that this process holds on a port the system
    picks, as torchrun's agent holds one: yields (port, env). Ranks run under
    `env` (torchrun's `MASTER_ADDR`, `MASTER_PORT` and
    `TORCHELASTIC_USE_AGENT_STORE`) join it as clients, whether they start
    from `env://` or from `tcp://<host>:<port>`, so no rank has to bind a
    port that another process may have taken since it was picked."""
    store = dist.TCPStore(host, 0, is_master=True, wait_for_workers=False)
    try:
        yield store.port, {"MASTER_ADDR": host, "MASTER_PORT": str(store.port),
                           "TORCHELASTIC_USE_AGENT_STORE": "True"}
    finally:
        del store


def _entry(rank: int, fn: Callable, world: int, store: str, backend: str, device: str, init: bool,
           args: Sequence[Any], out_dir: str, timeout: float, env: Dict[str, str]) -> None:
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.update(env)
    torch.set_num_threads(1)
    faulthandler.dump_traceback_later(timeout, exit=True)  # a rank that hangs fails the launch
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        if init:
            dist.init_process_group(backend, init_method=f"file://{store}", world_size=world, rank=rank,
                                    timeout=timedelta(seconds=timeout))
        result = {"ok": True, "value": fn(rank, world, *args)}
    except BaseException:  # noqa: BLE001 - handed to the parent with its traceback
        result = {"ok": False, "error": traceback.format_exc()}
    torch.save(result, os.path.join(out_dir, f"rank_{rank}.pt"))
    if not result["ok"]:
        os._exit(1)  # the launcher stops the ranks that wait for this one
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()


def launch(fn: Callable, nprocs: int, args: Sequence[Any] = (), backend: Optional[str] = None,
           device: str = "cuda", init: bool = True, timeout: float = 600.0,
           env: Optional[Dict[str, str]] = None) -> List[Any]:
    """fn(rank, nprocs, *args) on `nprocs` spawned processes; their return
    values in rank order."""
    device = resolve_device(device).type
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="launch_") as tmp:
        try:
            mp.start_processes(_entry, args=(fn, nprocs, os.path.join(tmp, "store"), backend, device, init,
                                             tuple(args), tmp, timeout, dict(env or {})),
                               nprocs=nprocs, join=True, start_method="spawn")
            exited = None
        except mp.ProcessExitedException as err:
            exited = str(err)
        paths = [os.path.join(tmp, f"rank_{r}.pt") for r in range(nprocs)]
        results = [torch.load(p, weights_only=False) if os.path.exists(p) else None for p in paths]
    failed = [f"rank {r} failed:\n{res['error']}" for r, res in enumerate(results) if res is not None and not res["ok"]]
    if exited is not None or failed:
        missing = [r for r, res in enumerate(results) if res is None]
        raise RuntimeError("".join(failed) + (f"{exited}; no result from ranks {missing}" if exited else ""))
    return [res["value"] for res in results]
