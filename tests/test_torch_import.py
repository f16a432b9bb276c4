"""The PyTorch port imports without JAX and without Triton, and neither it,
``chip_smoke.py`` (with the numpy references it takes from
``tests/ts_cases.py``) nor the probes under ``tools/`` import anything of
the JAX package or its bench; every kernel symbol it binds has a source."""

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
                                    "xhistogram_torch.ops.bincount"])
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


def test_no_port_file_imports_jax():
    sources = sorted((REPO / "xhistogram_torch").rglob("*.py"))
    assert sources
    scripts = [REPO / "chip_smoke.py", REPO / "tests" / "ts_cases.py",
               *sorted((REPO / "tools").glob("*.py"))]
    for path in sources + scripts:
        text = path.read_text()
        for banned in ("import jax", "from jax", "import xhistogram_tpu",
                       "from xhistogram_tpu", "import bench", "from bench"):
            assert banned not in text, (path, banned)


def test_every_declared_kernel_symbol_is_defined():
    """The C symbols ``ops/_build.py`` binds (joint2 with its mixed pairs,
    one_input with its narrow loads, and the four flat-slot routes of
    csrc/factored.cu and csrc/direct.cu with their mixed entries, per data
    type, unweighted and per weight class) are each defined once by a
    ``csrc/*.cu`` entry macro, the weighted ones through a macro that
    names a class's entries ``xh_<kernel>_<data>_##cls``."""
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
    assert len(declared) == 4 * (8 + 10 + 4 * 4 + 4)  # each unweighted and in 3 classes
    assert sorted(defined) == sorted(declared)
