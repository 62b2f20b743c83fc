"""Gloo ranks on one machine: the one helper that spawns them, for the
placed audits (``launch.placed_audit``), the analyzer's round targets
(``launch.analyze``) and the checkpoint-restart demo
(``launch.elastic.run_demo``).

:func:`spawn_ranks` starts ``world`` processes.  Each joins one gloo
group over a ``FileStore`` in a temporary directory (no port), calls
``target(rank, world, job)`` and writes the report it returns as
``rank{r}.json``.  A rank that raises writes its traceback to
``rank{r}.err`` and exits 1; the parent then stops the others (they
would wait on the dead rank's collectives until the limit) and raises
with every rank's traceback, so a failure names its cause; a rank that
dies by a signal leaves the Python stacks of its threads at that moment
(``faulthandler``), and so does each rank the parent stops (a failed
peer's, or past the limit: a hang names where it hung).

A rank that succeeds meets every other rank at a barrier before it
destroys its groups: gloo closes a rank's pairs when it tears down, and
a peer still reading from them would fail.  It then leaves with
``os._exit``, skipping the interpreter's teardown, which would run the
destructors of every group the rank created (a resize creates several
and none is destroyed) from the garbage collector's order.
"""
from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch.distributed as dist
import torch.multiprocessing as mp

#: how often the parent looks at its ranks while they run (seconds)
POLL_S = 0.05
#: the signal on which a rank dumps its threads' stacks, sent to every
#: rank the parent stops, and how long the parent gives it to write them
STACKS, DUMP_S = signal.SIGUSR1, 2.0


def _leave(code: int) -> None:
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _rank(target: Callable, rank: int, world: int, tmp: str,
          job: Dict[str, Any]) -> None:
    """One spawned process: join the group, run ``target``, write its
    report (or the traceback) and leave.  A rank killed by a signal (a
    crash in native code, an abort) dumps every thread's Python stack to
    ``rank{r}.fault`` first."""
    fault = open(os.path.join(tmp, f"rank{rank}.fault"), "w")
    faulthandler.enable(fault, all_threads=True)
    faulthandler.register(STACKS, fault, all_threads=True)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world)
        report = target(rank, world, job)
        dist.barrier()
        dist.destroy_process_group()
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    except BaseException:
        # the traceback for the parent, then out at once (no re-raise):
        # the teardown of a failed rank's groups can wait on peers that
        # the parent is about to stop
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        _leave(1)
    _leave(0)


def _failure(tmp: str, codes: List[Optional[int]], stopped: List[int],
             late: bool, timeout: float) -> str:
    """Every failed rank's traceback, or what is known of it."""
    why = f"past the {timeout:.0f} s limit" if late else "a rank failed"
    lines = [f"spawned ranks failed ({why}): exit codes {codes}, stopped "
             f"{stopped}"]
    for r, code in enumerate(codes):
        err = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                lines.append(f"--- rank {r} raised:\n{f.read().rstrip()}")
        elif r in stopped:
            lines.append(f"--- rank {r} was still running, stopped")
        elif code:
            lines.append(f"--- rank {r} exited {code} without a traceback"
                         + (f" (signal {-code})" if code < 0 else ""))
        fault = os.path.join(tmp, f"rank{r}.fault")
        if (r in stopped or code) and os.path.exists(fault) \
                and os.path.getsize(fault):
            with open(fault) as f:
                lines.append(f"    its stacks at the signal:\n"
                             f"{f.read().rstrip()}")
    return "\n".join(lines)


def spawn_ranks(world: int, job: Dict[str, Any], target: Callable, *,
                timeout: float, workdir: Optional[str] = None
                ) -> List[Dict[str, Any]]:
    """Run ``target(rank, world, job)`` on ``world`` spawned gloo ranks
    and return their reports in rank order.  ``target`` and ``job`` must
    pickle (a module-level function, plain data).  A rank that raises,
    dies or runs past ``timeout`` fails the run: the rest are stopped and
    this raises ``RuntimeError`` with every failed rank's traceback."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        procs = [ctx.Process(target=_rank, args=(target, r, world, tmp, job))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs) \
                and not any(p.exitcode for p in procs) \
                and time.monotonic() < deadline:
            time.sleep(POLL_S)
        stopped = [r for r, p in enumerate(procs) if p.is_alive()]
        failed = any(p.exitcode for p in procs)
        if stopped:
            # where each was: waiting on a failed peer, or hung
            for r in stopped:
                try:
                    os.kill(procs[r].pid, STACKS)
                except ProcessLookupError:  # it has left since
                    pass
            time.sleep(DUMP_S)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        if failed or stopped:
            codes = [None if r in stopped else p.exitcode
                     for r, p in enumerate(procs)]
            raise RuntimeError(_failure(tmp, codes, stopped, not failed,
                                        timeout))
        reports = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    return reports
