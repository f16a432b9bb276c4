"""Compare the SASS that two checkouts' kernel libraries compile to.

Run from the repository root on a machine with the CUDA toolkit, after
both libraries are built (``xhistogram_torch.ops._build.load()`` in each
checkout, as ``tools/weighted_probe.py --root`` does):

    python3 tools/sass_compare.py OTHER_ROOT [--match joint2_kernel]

For every kernel whose name contains ``--match`` and that both libraries
define (matched by their template arguments, so a kernel of one type for
both inputs, ``joint2_kernel<T, W>``, ``joint2_kernel<T, T, W>`` and
``joint2_kernel<T, T, T, T, W>`` (load types beside compare types), pairs
with its counterpart; a kernel that is no template, by its parameters),
it prints whether the two compile to the same instructions (addresses,
encodings and branch targets left out), or how many instructions each
has. A kernel that several sources compile (each in its own anonymous
namespace) matches only where every copy on both sides is the same. It
imports nothing of JAX.
"""

import argparse
import glob
import os
import re
import shutil
import subprocess


def kernel_bodies(root, match):
    """{template arguments (or parameters): the set of their copies'
    instructions} of the kernels named ``match`` in the library built
    under ``root``."""
    libs = glob.glob(os.path.join(root, "xhistogram_torch", "_build", "*.so"))
    if not libs:
        raise SystemExit(f"no built library under {root}/xhistogram_torch/_build")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", libs[0]], capture_output=True, text=True,
                         check=True, timeout=600).stdout
    bodies = {}
    for block in re.split(r"\n(?=\s*Function : )", out):
        m = re.search(rf"Function : \S*{match}(?:I(\w+?)EEE?v|E(\w+))", block)
        if not m:
            continue
        args = m.group(1) if m.group(1) is not None else m.group(2)
        # joint2: <T, W>, <T, T, W> and <T, T, T, T, W> (one type for both
        # inputs, read as itself) pair up, as do <A, B, W> and <A, B, A, B, W>
        args = re.sub(r"^([fdix])\1+(?=N2xh)", r"\1", args)
        args = re.sub(r"^([fdix][fdix])\1(?=N2xh)", r"\1", args)
        body = []
        for line in block.splitlines()[1:]:
            if not re.search(r"/\*[0-9a-f]{4}\*/", line):
                continue
            line = re.sub(r"/\*[0-9a-f]{4}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
            if re.search(r"\b(BRA|BSSY|CALL|JMP)\b", line):  # a branch target
                line = re.sub(r"0x[0-9a-f]+", "", line)
            body.append(line)
        bodies.setdefault(args, set()).add(tuple(body))
    return bodies


def main():
    p = argparse.ArgumentParser()
    p.add_argument("other_root")
    p.add_argument("--match", default="joint2_kernel")
    args = p.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mine = kernel_bodies(here, args.match)
    theirs = kernel_bodies(os.path.abspath(args.other_root), args.match)
    for name in sorted(set(mine) & set(theirs)):
        a, b = theirs[name], mine[name]
        verdict = "identical" if a == b else (
            f"differs: {sorted(map(len, a))} against {sorted(map(len, b))} instructions")
        print(f"# {args.match}<{name}>: {verdict}")
    print(f"# {len(set(mine) & set(theirs))} kernels in both; only here: "
          f"{len(set(mine) - set(theirs))}, only in {args.other_root}: "
          f"{len(set(theirs) - set(mine))}")


if __name__ == "__main__":
    main()
