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
    """The C symbols ``ops/_build.py`` binds (joint2 with its narrow and
    mixed pairs, one_input with its narrow loads, the four flat-slot routes
    of csrc/factored.cu and csrc/direct.cu with their mixed and narrow
    entries, and the direct-row kernel of csrc/direct.cuh with its narrow
    entry, per data type, unweighted and per weight class, its rounded
    float32 class included) are each defined once by a ``csrc/*.cu`` entry
    macro, the weighted ones through a macro that names a class's entries
    ``xh_<kernel>_<data>_##cls``."""
    import re

    from xhistogram_torch.ops import _build

    csrc = REPO / "xhistogram_torch" / "csrc"
    per_class = {}  # class macro -> the entries it defines, less the class
    for path in sorted(csrc.glob("*.cu*")):
        for macro, body in re.findall(r"^#define (XH_\w+_CLASS)\(cls, A\)((?:.*\\\n)*.*)",
                                      path.read_text(), re.M):
            per_class[macro] = re.findall(r"\((xh_\w+)_##cls,", body)
    defined = []
    for path in sorted(csrc.glob("*.cu")):
        text = path.read_text()
        defined += re.findall(r"^XH_\w+\((xh_\w+),", text, re.M)
        for macro, cls in re.findall(r"^(XH_\w+_CLASS)\((\w+),", text, re.M):
            defined += [f"{name}_{cls}" for name in per_class[macro]]
    declared = [name for name, _ in _build.symbols()]
    # each unweighted and in 3 classes (joint2 14 suffixes, one_input 10,
    # four routes of 4 types, mixed and narrow); the direct-row kernel in 4,
    # for its 4 types and narrow
    assert len(declared) == 4 * (14 + 10 + 4 * 4 + 4 + 4) + 5 * 5
    assert sorted(defined) == sorted(declared)
