"""The PyTorch port imports without JAX and without Triton, and neither it,
``chip_smoke.py`` (with the numpy references it takes from
``tests/ts_cases.py``) nor the probes under ``tools/`` import anything of
the JAX package or its bench; every kernel symbol it binds has a source."""

import pathlib
import subprocess
import sys

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
    """The C symbols ``ops/_build.py`` binds (joint2, one_input and the four
    flat-slot routes of csrc/factored.cu and csrc/direct.cu, per data type)
    are each defined once by a ``csrc/*.cu`` entry macro."""
    import re

    from xhistogram_torch.ops import _build

    defined = []
    for path in sorted((REPO / "xhistogram_torch" / "csrc").glob("*.cu")):
        defined += re.findall(r"^XH_\w+\((xh_\w+),", path.read_text(), re.M)
    declared = [f"xh_{kernel}_{suffix}" for suffix in _build.DTYPE_SUFFIXES
                for kernel in ("joint2", "one_input", *_build.SLOT_ROUTES)]
    assert sorted(defined) == sorted(declared)
