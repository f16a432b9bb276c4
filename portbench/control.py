"""The control of ``correct``: the plain reference, its data and weights
rounded to the configuration's lower precision (``control_dtype``:
bfloat16 for float32 data), in the program's place. It has to come out as
not correct.

    python3 portbench/control.py --workload NAME --seconds S SEED [SEED ...]

runs the cell once for each seed with the program and once with the control
in its place (``in_the_programs_place``, a hook of ``harness.run_cell``),
at the cell's own size and through the harness's own check, in one
process, and prints one JSON line a seed: each number compared, for the
program and for the control, beside its limit, and whether each run was
correct. These are the readings the limits are set from.
"""

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HOOK = "portbench.control:in_the_programs_place"


def in_the_programs_place(cell):
    """Put the control in place of the program's sums
    (``core._histogram_impl``, under every public entry, and its copy in
    ``parallel.sharded`` where that is loaded); returns the undo. In a
    sharded call the control makes this rank's part and the program's
    all-reduce (``mesh.sum``) adds the parts, as it adds the program's."""
    import torch

    import xhistogram_torch.core as core

    from portbench import reference

    lowp = getattr(torch, cell.config["control_dtype"])

    def control(args, weights, edges_np, bins, axis, mesh=None, **kwargs):
        h = reference.histogram(list(args), list(edges_np), axis, weights, lowp)
        nslots = math.prod(len(e) - 1 for e in edges_np)
        rows = h.reshape(-1, nslots)
        sums = torch.cat([rows, rows.new_zeros((rows.shape[0], 1))], dim=1)  # trash slot
        kshape = tuple(h.shape[: h.ndim - len(edges_np)])
        if mesh is not None:
            sums = mesh.sum(sums)
        return sums, kshape, None if weights is None else weights.dtype

    return replace_impl(lambda impl: control)


def replace_impl(make):
    """Replace the program's ``_histogram_impl`` by ``make(impl)`` in
    ``xhistogram_torch.core`` and, where it is loaded, in
    ``xhistogram_torch.parallel.sharded``, which holds its own reference to
    it; returns the undo."""
    import xhistogram_torch.core as core

    modules = [core]
    if "xhistogram_torch.parallel.sharded" in sys.modules:
        modules.append(sys.modules["xhistogram_torch.parallel.sharded"])
    impl = core._histogram_impl
    for module in modules:
        module._histogram_impl = make(impl)

    def undo():
        for module in modules:
            module._histogram_impl = impl

    return undo


def main(argv=None):
    p = argparse.ArgumentParser(description="program and control readings by seed")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("seeds", type=int, nargs="+")
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    program = harness.run_cell(args.workload, args.seeds, args.seconds, False, "cuda")
    control = harness.run_cell(args.workload, args.seeds, args.seconds, False, "cuda",
                               hook=HOOK)
    for seed, (line, _), (cline, _) in zip(args.seeds, program, control):
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {n: c["value"] for n, c in line["checks"].items()},
            "control": {n: c["value"] for n, c in cline["checks"].items()},
            "limits": {n: c["limit"] for n, c in line["checks"].items()},
            "correct": line["correct"], "control_correct": cline["correct"],
            "calls": line["attempted"], "control_calls": cline["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
