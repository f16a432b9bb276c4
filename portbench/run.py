"""Run one cell of the benchmark of xhistogram_torch on the cards of this
machine and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a run profiled on the
device. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit,
which also close standard error. Exits non-zero and prints no result
without a CUDA card or with fewer cards than the cell asks for, when the
program is not in the checkout, or when a module of JAX or of the JAX
package was loaded.

A cell on several cards runs one process a card: this one is rank 0, on
``cuda:0``, and starts the others (``portbench/procs.py``) before its own
imports; it alone prints the line. If a rank fails or hangs, every rank
exits non-zero and no line is printed (``procs``' deadlines).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"
# every cache of the program and of the libraries it builds with, at fixed
# paths inside the checkout, so only a checkout's first run builds
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "1")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description="one cell of the xhistogram_torch benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = p.parse_args(argv)

    from portbench import procs, registry

    children = None
    chips = {w["name"]: w["chips"] for w in registry.benchmark()["workloads"]}
    if chips.get(args.workload, 1) > 1:  # the other ranks' imports overlap this one's
        children = procs.Children(args.workload, chips[args.workload], [args.seed],
                                  args.seconds, bool(args.trace), "cuda")
    try:
        return _run(args, children)
    except procs.RankFailure as e:
        print(f"no line: {e}", file=sys.stderr)
        return procs.EXIT_RANK
    finally:
        if children is not None:
            children.stop()


def _run(args, children):
    from portbench.registry import Cell

    cell = Cell(args.workload)
    marks = [("start and the cell's files", time.perf_counter())]
    import torch

    marks.append(("import torch", time.perf_counter()))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {cell.name} needs {cell.chips} CUDA cards; this machine has {n}",
              file=sys.stderr)
        return 2
    marks.append(("the card's count", time.perf_counter()))
    try:
        import xhistogram_torch
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    if ROOT not in Path(xhistogram_torch.__file__).resolve().parents:
        print(f"xhistogram_torch was imported from {xhistogram_torch.__file__}, not from "
              f"the checkout at {ROOT}", file=sys.stderr)
        return 2

    marks.append(("import xhistogram_torch", time.perf_counter()))
    from portbench import harness

    marks.append(("the harness's imports", time.perf_counter()))
    [(line, notes)] = harness.run_cell(cell.name, [args.seed], args.seconds,
                                       bool(args.trace), "cuda", T_PROCESS, marks=marks,
                                       children=children)
    found = harness.forbidden_modules()
    if found:
        print(f"modules loaded that no run may load: {found}", file=sys.stderr)
        return 3
    harness.emit(line, notes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
