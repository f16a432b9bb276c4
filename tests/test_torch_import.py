"""The PyTorch port imports without JAX and without Triton, and neither it
(its sharded layer ``parallel/`` and ``ops/partitioning.py`` included),
``chip_smoke.py`` (with the numpy references it takes from
``tests/ts_cases.py``), the gloo rank helpers of the sharded tests nor the
probes under ``tools/`` import anything of the JAX package or its bench;
importing it starts no process group; every kernel symbol it binds has a
source."""

import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_import_leaves_jax_and_triton_out():
    code = (
        "import sys, xhistogram_torch, xhistogram_torch.ops.cuda_hist, "
        "xhistogram_torch.ops._build; "
        "print(sorted(m for m in ('jax', 'triton', 'xhistogram_tpu') "
        "if m in sys.modules))"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


@pytest.mark.parametrize("module", ["xhistogram_torch.streaming", "xhistogram_torch.labeled",
                                    "xhistogram_torch.labeled.api", "xhistogram_torch.compat",
                                    "xhistogram_torch.ops.bincount",
                                    "xhistogram_torch.parallel",
                                    "xhistogram_torch.parallel.sharded",
                                    "xhistogram_torch.ops.partitioning",
                                    "xhistogram_torch.utils.profiling"])
def test_new_modules_leave_jax_out(module):
    """Each module of the public API above core imports alone without JAX
    or the JAX package, and the package exports them as the JAX one does."""
    code = (
        f"import sys, importlib; importlib.import_module({module!r}); "
        "import xhistogram_torch as x; "
        "assert all(hasattr(x, n) for n in ('core', 'ops', 'labeled', 'streaming', "
        "'compat', 'histogram', 'StreamingHistogram')); "
        "print(sorted(m for m in ('jax', 'xhistogram_tpu') if m in sys.modules))"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_import_initialises_no_process_group():
    """Importing the port, its sharded layer and the ops' sharding rules
    starts no torch.distributed process group and leaves JAX out."""
    code = (
        "import sys, torch, xhistogram_torch, xhistogram_torch.parallel, "
        "xhistogram_torch.ops.partitioning; "
        "assert xhistogram_torch.parallel.histogram_sharded; "
        "assert not torch.distributed.is_initialized(); "
        "print(sorted(m for m in ('jax', 'triton', 'xhistogram_tpu') if m in sys.modules))"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_no_port_file_imports_jax():
    sources = sorted((REPO / "xhistogram_torch").rglob("*.py"))
    assert sources
    assert {"parallel/sharded.py", "ops/partitioning.py"} <= {
        str(p.relative_to(REPO / "xhistogram_torch")) for p in sources}
    scripts = [REPO / "chip_smoke.py", REPO / "tests" / "ts_cases.py",
               *(REPO / "tests" / f for f in ("torch_dist.py", "torch_sharded_cases.py",
                                              "torch_ops_cases.py")),
               *sorted((REPO / "tools").glob("*.py"))]
    for path in sources + scripts:
        text = path.read_text()
        for banned in ("import jax", "from jax", "import xhistogram_tpu",
                       "from xhistogram_tpu", "import bench", "from bench"):
            assert banned not in text, (path, banned)


def test_every_declared_kernel_symbol_is_defined():
    """The C symbols ``ops/_build.py`` binds (joint2 with its narrow types,
    its pairs of two types and its mixed entry, one_input with its narrow
    loads, the flat-slot kernel of csrc/slot.cu with its mixed and narrow
    entries, and the direct-row kernel of
    csrc/direct.cuh with its narrow and mixed entries, per data type,
    unweighted and per weight class, its rounded float32 class included)
    are each defined once by a ``csrc/*.cu`` entry macro: one that names
    its entry, or one that builds the names by pasting its arguments into
    the entries of the macros it calls (``xh_<kernel>_<data>_##cls``,
    ``xh_joint2_##sa##_##sb``)."""
    import re

    from xhistogram_torch.ops import _build

    csrc = REPO / "xhistogram_torch" / "csrc"
    templates = {}  # macro -> (its parameters, the entry names it pastes)
    for path in sorted(csrc.glob("*.cu*")):
        for macro, params, body in re.findall(
                r"^#define (XH_\w+)\(([^)]*)\)((?:.*\\\n)*.*)", path.read_text(), re.M):
            templates[macro] = ([p.strip() for p in params.split(",")],
                                re.findall(r"\((xh_\w*##[\w#]*),", body))

    def paste(template, params, args):
        values = dict(zip(params, args))
        return "".join(values.get(token, token) for token in template.split("##"))

    defined = []
    for path in sorted(csrc.glob("*.cu")):
        for macro, args in re.findall(r"^(XH_\w+)\(([^)]*)\)", path.read_text(), re.M):
            args = [a.strip() for a in args.split(",")]
            if args[0].startswith("xh_"):
                defined.append(args[0])
            else:
                params, names = templates[macro]
                defined += [paste(t, params, args) for t in names]
    declared = [name for name, _ in _build.symbols()]
    # each unweighted and in 3 classes (joint2 32 suffixes and its mixed
    # entry, one_input 12, the flat-slot kernel's 4 types, mixed and
    # narrow); the direct-row kernel in 5, for its 4 types, narrow and mixed
    assert len(declared) == 4 * (32 + 1 + 12 + 4 + 1 + 1) + 5 * 6
    assert sorted(defined) == sorted(declared)
