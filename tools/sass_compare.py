#!/usr/bin/env python3
"""Instruction counts of the K kernels of two builds of the port, side by
side: for every instantiation of a library in the first build, its SASS
instruction count there, the count of the same instantiation in the
second build (or, where the second build has none, of its whole-domain
EXT = 0 one with the same modes), and how many instructions of the two
sequences match in order (a measure of how far the compiler
rescheduled).  Needs ``cuobjdump`` (the CUDA toolkit).

    python tools/sass_compare.py build/parent/build/bflbm_tpu_torch \\
        build/bflbm_tpu_torch [library ...]

Built libraries are ``lib<name>.<hash>.so`` in each directory; the
default libraries are fused_step, fused_step_force and
fused_step_general_force.
"""

import difflib
import glob
import os
import re
import subprocess
import sys

CUOBJDUMP = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "cuobjdump")


def kernels(so):
    """{mangled name: [instruction text]} of one shared library."""
    out = subprocess.run([CUOBJDUMP, "-sass", so], capture_output=True,
                         text=True, check=True).stdout
    res, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            res[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?);", ln)
        if m and name:
            res[name].append(re.sub(r"\s+", " ", m.group(2)).strip())
    return res


def template_args(name):
    return re.findall(r"L[bi](\d+)E", name)


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    first, second = argv[:2]
    libs = argv[2:] or ["fused_step", "fused_step_force",
                        "fused_step_general_force"]
    for lib in libs:
        a = kernels(glob.glob(os.path.join(first, f"lib{lib}.*.so"))[0])
        b = kernels(glob.glob(os.path.join(second, f"lib{lib}.*.so"))[0])
        for name, body in sorted(a.items()):
            full = template_args(name)
            args = full[:6]
            match = ([n for n in b if template_args(n) == full]
                     or [n for n in b
                         if template_args(n) in (args + ["0"], args)])
            if not match:
                print(f"{lib} <{','.join(args)}>: no counterpart")
                continue
            other = b[match[0]]
            same = sum(m.size for m in difflib.SequenceMatcher(
                None, body, other, autojunk=False).get_matching_blocks())
            print(f"{lib} <{','.join(full)}>: {len(body)} instructions, "
                  f"{len(other)} in the second build, {same} matching in "
                  "order")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
