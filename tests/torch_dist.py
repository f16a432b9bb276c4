"""Spawns gloo ranks on the CPU for the port's multi-rank tests.

``run_ranks(suite, tmp_path, world)`` starts ``world`` processes of this
file, each a rank of one ``torch.distributed`` gloo group (``file://``
rendezvous in ``tmp_path``, so concurrent test workers never share a
port), runs ``run(rank, world)`` of the module ``suite`` in each, and
returns each rank's results. A rank that raises, or a run that outlasts
``timeout`` seconds (a deadlock), fails the caller; every process is killed
before it returns. The ranks import torch and the port only, never JAX.

Run as a script it is one rank:

    python tests/torch_dist.py SUITE RANK WORLD INIT_FILE OUT_DIR
"""

import importlib
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def run_ranks(suite, tmp_path, world=4, timeout=120):
    tmp_path = pathlib.Path(tmp_path)
    init = tmp_path / f"{suite}_rendezvous"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    logs = [open(tmp_path / f"{suite}_rank{r}.log", "w+") for r in range(world)]
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, suite, str(r), str(world), str(init), str(tmp_path)],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
        )
        for r, log in enumerate(logs)
    ]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for log in logs:
        log.seek(0)
        out.append(log.read())
        log.close()
    if hung:
        raise AssertionError(f"ranks {hung} of {suite} did not finish in {timeout} s:\n"
                             + "\n".join(out))
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(f"ranks {failed} of {suite} failed:\n" + "\n".join(out))
    import torch

    return [torch.load(tmp_path / f"{suite}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def main():
    suite, rank, world, init, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        results = importlib.import_module(suite).run(rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(results, pathlib.Path(out) / f"{suite}_rank{rank}.pt")


if __name__ == "__main__":
    main()
