"""Run a function in N rank processes of one ``torch.distributed`` group.

The JAX tools drive a multi-device mesh from one process; the port runs
one process per rank. ``run(world, fn, *args, device=...)`` starts
``world`` processes with the ``spawn`` start method, joins them into one
process group on a free localhost port and calls ``fn(device, *args)`` in
each, ``device`` being that rank's ``torch.device``; it returns each rank's
result, in rank order. ``run_calls`` runs several such calls in order over
one group, so that a caller pays the processes' start once.

* On CUDA: NCCL, rank ``r`` on ``cuda:r``. A world larger than
  ``torch.cuda.device_count()`` raises before any process starts: NCCL
  refuses two ranks on one card, and nothing here puts them there.
* On the CPU: gloo, each rank with its share of the caller's threads
  (``torch.get_num_threads()``).

A result must be JSON-able (it crosses as JSON text). A rank that raises
fails the whole call: its traceback is printed to standard error, the other ranks are
stopped and ``run`` raises ``RuntimeError``.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import queue as queue_mod
import socket
import sys
import time
import traceback
from typing import Any, Callable, List, Sequence, Tuple

import torch

Call = Tuple[Callable, tuple]


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, device_type: str, threads: int,
               calls: Sequence[Call], results) -> None:
    import torch.distributed as dist

    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device, backend = torch.device("cuda", rank), "nccl"
        else:
            torch.set_num_threads(threads)
            device, backend = torch.device("cpu"), "gloo"
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        try:
            out = [fn(device, *args) for fn, args in calls]
        finally:
            dist.destroy_process_group()
        results.put((rank, True, json.dumps(out)))
    except BaseException:  # reported to the caller, which fails the whole run
        results.put((rank, False, traceback.format_exc()))


def check_world(world: int, device) -> torch.device:
    """``device`` as a ``torch.device``; raises where ``world`` ranks cannot
    each have a card of their own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was requested but torch.cuda.is_available() is "
                               "False; pass device='cpu' to run the ranks on the CPU (gloo)")
        have = torch.cuda.device_count()
        if world > have:
            raise ValueError(f"need {world} devices, have {have} "
                             f"({torch.cuda.get_device_name(0)}): one NCCL rank a card")
    elif dev.type != "cpu":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {dev}")
    if world < 1:
        raise ValueError(f"world size {world}")
    return dev


def run_calls(world: int, calls: Sequence[Call], device="cuda",
              timeout: float = 900.0) -> List[List[Any]]:
    """Call each ``fn(rank_device, *args)`` of ``calls`` in order in every
    one of ``world`` rank processes; returns ``out[call][rank]``."""
    dev = check_world(world, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    threads = max(1, torch.get_num_threads() // world)
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, dev.type, threads,
                                                  list(calls), results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got, failed = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(failed) < world and not failed:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    failed += [(r, f"rank {r} exited with code {procs[r].exitcode} "
                                   "before it reported") for r in dead]
                elif time.monotonic() > deadline:
                    failed.append((-1, f"ranks {sorted(set(range(world)) - set(got))} did not "
                                       f"report within {timeout:.0f} s"))
                continue
            if ok:
                got[rank] = json.loads(payload)
            else:
                failed.append((rank, payload))
    finally:
        for p in procs:
            if failed:
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        for rank, text in failed:
            print(f"rank {rank} of {world} failed:\n{text}", file=sys.stderr, flush=True)
        raise RuntimeError(f"{len(failed)} of {world} ranks failed (first: rank {failed[0][0]})")
    return [[got[r][i] for r in range(world)] for i in range(len(calls))]


def run(world: int, fn: Callable, *args, device="cuda", timeout: float = 900.0) -> List[Any]:
    """``fn(rank_device, *args)`` in each of ``world`` ranks; each rank's
    result, in rank order."""
    return run_calls(world, [(fn, args)], device, timeout)[0]
