"""The processes of a cell on several cards: rank 0 starts one process for
each further card, and every rank watches the others.

Rank 0 is the process that ``run.py`` (or ``harness.run_cell``) runs in. It
picks a free localhost port, where the ranks meet, and starts rank r (1 to
n - 1) as ``python3 portbench/ranks.py ...`` with the same cell, seeds and
settings. This module imports no torch, so ``run.py`` can start the other
ranks before its own imports, and their imports overlap.

A rank that fails or hangs ends every rank within a stated time, and no
line is printed:

- rank 0 polls its children every ``POLL_S``; one that exits with another
  code than 0 makes rank 0 stop the others and exit with ``EXIT_RANK``;
- a child whose parent, rank 0, has ended exits with ``EXIT_RANK``;
- each rank arms a deadline for each phase (``Watchdog.arm``): the
  rendezvous, the library's build, each seed's run; a rank that passes one
  says which and exits with ``EXIT_RANK``, and rank 0 stops its children
  first.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: how often a rank looks at the others
POLL_S = 0.5
#: the exit code of a rank that ends because a rank failed or hung
EXIT_RANK = 4
#: phase deadlines: the ranks' rendezvous (their imports included), the
#: library's build in a checkout's first run, and one seed's run after the
#: build (its set-up, ``--seconds`` of window and the check come on top)
RENDEZVOUS_S = 240.0
BUILD_S = 1000.0
SEED_S = 300.0
#: how long rank 0 waits for its children to exit after the last seed
JOIN_S = 60.0


class RankFailure(RuntimeError):
    """A rank of the cell failed: no line may be printed."""


def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Children:
    """Ranks 1 to ``world - 1``, started by rank 0 for one cell, and the
    localhost port where all ranks meet."""

    def __init__(self, cell_name, world, seeds, seconds, trace, device_type,
                 hook=None, here=None):
        self.port = free_port()
        self.procs = []
        here = HERE if here is None else Path(here)
        for rank in range(1, world):
            cmd = [sys.executable, str(HERE / "ranks.py"), "--cell", cell_name,
                   "--here", str(here), "--rank", str(rank), "--world", str(world),
                   "--port", str(self.port), "--seconds", repr(float(seconds)),
                   "--trace", str(int(trace)), "--device-type", device_type,
                   "--hook", hook or "", "--seeds", *map(str, seeds)]
            # a child prints nothing on standard output: only rank 0's line
            self.procs.append(subprocess.Popen(cmd, stdout=subprocess.DEVNULL))

    def failed(self):
        """(rank, exit code) of a child that ended with another code than
        0, or None."""
        for rank, p in enumerate(self.procs, start=1):
            rc = p.poll()
            if rc not in (None, 0):
                return rank, rc
        return None

    def stop(self):
        """Kill every child still running and wait for each to end."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def join(self, timeout=JOIN_S):
        """Wait for the children to exit; [(rank, code)] of those that did
        not exit with 0 (-9 for one killed at ``timeout``)."""
        end = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        self.stop()
        return [(r, p.returncode) for r, p in enumerate(self.procs, start=1)
                if p.returncode != 0]


class Watchdog:
    """A thread that ends this rank, and rank 0's children with it, when a
    phase passes its deadline, when a child fails (rank 0), or when rank 0
    has ended (another rank)."""

    def __init__(self, rank, children=None):
        self.rank = rank
        self.children = children
        self.parent = os.getppid()
        self.deadline = None
        self.what = ""
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def arm(self, seconds, what):
        """From now, ``what`` has ``seconds`` to end (until the next arm)."""
        self.what, self.seconds = what, seconds
        self.deadline = time.monotonic() + seconds

    def close(self):
        self._done.set()
        self._thread.join()

    def _reason(self):
        if self.deadline is not None and time.monotonic() > self.deadline:
            return f"{self.what} did not end within {self.seconds:.0f} s"
        if self.rank and os.getppid() != self.parent:
            return "rank 0 has ended"
        if self.children is not None:
            bad = self.children.failed()
            if bad:
                return f"rank {bad[0]} exited with code {bad[1]}"
        return None

    def _watch(self):
        while not self._done.wait(POLL_S):
            reason = self._reason()
            if reason:
                print(f"rank {self.rank}: {reason}; every rank exits with code {EXIT_RANK} "
                      "and no line is printed", file=sys.stderr, flush=True)
                if self.children is not None:
                    self.children.stop()
                os._exit(EXIT_RANK)
