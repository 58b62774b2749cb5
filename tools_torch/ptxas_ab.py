#!/usr/bin/env python3
"""Registers, stack frames and spills of every kernel instance of two
checkouts of the PyTorch port, side by side.

Usage: ``python3 tools_torch/ptxas_ab.py <root a> <root b>``, from the root
of a checkout, on a machine with ``nvcc``. Each checkout's kernel library
is built anew in its own process (both at once, each into a build
directory of its own under ``build/ptxas_ab``, so that a library
built before does not hide the report), with ``-Xptxas -v`` as
``ops/hopper/_build.py`` always builds it; each instance's line of that
report (``chip_smoke.ptxas_summary``) is printed for a and for b, and the
instances whose register count grew are listed last. Exits 1 where one
grew.
"""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

BUILD = ("import pathlib, sys\n"
         "from differentialdynamicprogramming_jl_tpu_torch.ops.hopper import "
         "_build\n"
         "_build.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
         "sys.stdout.write(_build.build().log)\n")


def main(a: str, b: str) -> int:
    import shutil
    out_dir = os.path.join(ROOT, "build", "ptxas_ab")
    dirs = [os.path.join(out_dir, label) for label in ("a", "b")]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, d],
                              cwd=os.path.abspath(r),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r, d in zip((a, b), dirs)]
    logs = []
    for r, p in zip((a, b), procs):
        out, err = p.communicate()
        if p.returncode != 0:
            print(f"build in {r} failed:\n{err[-3000:]}")
            return 2
        logs.append({line.split(":")[0]: line for line in
                     cs.ptxas_summary(out)})
    grew = []
    for name in sorted(set(logs[0]) | set(logs[1])):
        la, lb = (lg.get(name, "") for lg in logs)
        print(f"{name}\n  a: {la.split(': ', 1)[-1]}\n  b: "
              f"{lb.split(': ', 1)[-1]}")
        ra, rb = (re.search(r": (\d+) registers", x) for x in (la, lb))
        if ra and rb and int(rb.group(1)) > int(ra.group(1)):
            grew.append(name)
    print(f"instances: {len(logs[0])} in a, {len(logs[1])} in b; registers "
          f"grew in: {grew or 'none'}")
    return 1 if grew else 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
