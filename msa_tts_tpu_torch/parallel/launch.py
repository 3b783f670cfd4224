"""Start ``world`` ranks of one function on this host, each in a fresh
process (``spawn``) with the default process group up over a file store:

    spawn(fn, 2, arg, store=os.path.join(tmp, "store"))

runs ``fn(rank, world, arg)`` on ranks 0 and 1 and returns when both
have; a rank that raises makes ``spawn`` raise (the others are stopped).
The backend is gloo, the one that ranks sharing one device, or the CPU,
can use.  Each rank uses one torch thread, and a collective that waits
longer than ``TIMEOUT_S`` raises in its rank.  ``torchrun`` is the
launcher for real runs; this is for tests and checks.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


TIMEOUT_S = 300


def _entry(rank: int, fn, world: int, store: str, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, store: str, join: bool = True):
    """Run ``fn(rank, world, *args)`` on ``world`` fresh processes;
    ``store`` is a path that must not exist yet (the ranks' rendezvous
    file).  ``fn`` must be importable by name from the children.  With
    ``join=False`` it returns at once with ``wait(timeout=None)``, which
    waits for the ranks (raising as ``spawn`` would); with a timeout in
    seconds it returns whether they have all ended by then."""
    if os.path.exists(store):
        raise FileExistsError(f"rendezvous file {store} exists")
    ctx = mp.start_processes(
        _entry, args=(fn, world, store, args),
        nprocs=world, join=False, start_method="spawn")

    def wait(timeout: float | None = None) -> bool:
        if timeout is not None:
            return ctx.join(timeout)
        while not ctx.join():
            pass
        return True

    if join:
        wait()
    return wait
