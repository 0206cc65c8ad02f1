#!/usr/bin/env python3
"""Instruction counts of the K kernels of two builds of the port, side by
side: for every instantiation of a library in the first build, its SASS
instruction count there, the count of the same instantiation in the
second build (or, where the second build has none, of its whole-domain
EXT = 0 one with the same modes), and how many instructions of the two
sequences match in order (a measure of how far the compiler
rescheduled).  Needs ``cuobjdump`` (the CUDA toolkit).

    PYTHONPATH=. python tools/sass_compare.py \\
        build/parent/build/bflbm_tpu_torch build/bflbm_tpu_torch \\
        [library ... | --all]

Built libraries are ``lib<name>.<hash>.so`` in each directory; the
default libraries are fused_step, fused_step_force and
fused_step_general_force, ``--all`` takes every library of
``_build.LIBRARIES``.  Instantiations are paired by function name and
template arguments; the last line counts those whose instruction
sequences are identical in both builds.
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


def function_name(mangled):
    """The unqualified name of an Itanium-mangled function (the last of
    the length-prefixed names after ``_Z`` / ``_ZN``)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if m is None:
            return name
        pos += len(m.group(0))
        name = mangled[pos:pos + int(m.group(0))]
        pos += int(m.group(0))


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    first, second = argv[:2]
    libs = argv[2:] or ["fused_step", "fused_step_force",
                        "fused_step_general_force"]
    if libs == ["--all"]:
        from bflbm_tpu_torch.kernels import _build

        libs = list(_build.LIBRARIES)
    total = identical = 0
    for lib in libs:
        a = kernels(glob.glob(os.path.join(first, f"lib{lib}.*.so"))[0])
        b = kernels(glob.glob(os.path.join(second, f"lib{lib}.*.so"))[0])
        for name, body in sorted(a.items()):
            fn, full = function_name(name), template_args(name)
            args = full[:6]
            match = ([n for n in b if function_name(n) == fn
                      and template_args(n) == full]
                     or [n for n in b if function_name(n) == fn
                         and template_args(n) in (args + ["0"], args)])
            total += 1
            if not match:
                print(f"{lib} {fn}<{','.join(full)}>: no counterpart")
                continue
            other = b[match[0]]
            same = sum(m.size for m in difflib.SequenceMatcher(
                None, body, other, autojunk=False).get_matching_blocks())
            identical += int(body == other)
            print(f"{lib} {fn}<{','.join(full)}>: {len(body)} instructions, "
                  f"{len(other)} in the second build, {same} matching in "
                  f"order{', identical' if body == other else ''}")
    print(f"{identical} of {total} instantiations identical")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
