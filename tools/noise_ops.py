#!/usr/bin/env python3
"""Operations a cell of each noise-probe case, counted in the SASS of its
build (``csrc/probe_noise.cu``: one thread a cell, no loops), by the pipe
that executes them on the H100:

- integer: the ALU pipe's instructions (LOP3, SHF, IADD3, LEA, ISETP,
  PRMT, SEL, ...), 64 a clock an SM;
- float: the FMA pipe's instructions (FFMA, FADD, FMUL and the integer
  multiplies IMAD / IMUL, its moves excepted), 128 a clock an SM, given
  as two operations each against ``chip_smoke.py``'s ``F32_OPS`` (256
  flops a clock an SM).

Only code outside every BSSY / BSYNC region and before the last EXIT is
counted, the code every thread executes: the regions and the blocks
after the last EXIT hold the libm slow paths of the Box-Muller cases
(``sinf`` / ``cosf`` argument reduction, ``logf``), which run for few or
no inputs.  Instructions of other pipes (conversions, MUFU,
VIADD, FSETP / FSEL, memory, control) bound nothing here, so the counts
give a lower bound on the time.

Prints one line a case (the counts, then every opcode outside and inside
the regions) and, last, ``probes/noise_micro.py``'s ``OPS`` table of
(integer, float) pairs.  Needs the card (it builds the library) and
``cuobjdump`` (the CUDA toolkit).

    PYTHONPATH=. python tools/noise_ops.py
"""

import os
import re
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sass_compare import kernels, template_args  # noqa: E402

ALU = {"LOP3", "LOP", "SHF", "SHL", "SHR", "IADD3", "IADD", "LEA",
       "ISETP", "IMNMX", "PRMT", "IABS", "SEL", "SGXT", "BMSK", "BREV"}
FMA = {"FFMA", "FADD", "FMUL", "IMAD", "IMUL"}


def opcode(ins):
    """The opcode of a SASS instruction, its predicate dropped."""
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def split_regions(instructions):
    """(opcodes outside every BSSY / BSYNC region and before the last
    EXIT, the others: the regions and the blocks placed after the last
    EXIT, reached only by a branch)."""
    ops = [opcode(ins) for ins in instructions]
    last_exit = max(i for i, op in enumerate(ops) if op.startswith("EXIT"))
    outside, inside, depth = [], [], 0
    for i, op in enumerate(ops):
        if op.startswith("BSSY"):
            depth += 1
        (inside if depth or i > last_exit else outside).append(op)
        if op.startswith("BSYNC"):
            depth = max(depth - 1, 0)
    return outside, inside


def counts(opcodes):
    """(ALU-pipe integer instructions, FMA-pipe instructions x 2)."""
    n_alu = n_fma = 0
    for op in opcodes:
        base = op.split(".")[0]
        if base in ALU:
            n_alu += 1
        elif base in FMA and ".MOV" not in op:
            n_fma += 1
    return n_alu, 2 * n_fma


def main() -> int:
    import torch

    from bflbm_tpu_torch.kernels import _build
    from bflbm_tpu_torch.probes import noise_micro

    _build.load("probe_noise", torch.device("cuda", 0))
    sass = kernels(str(_build.library_path("probe_noise")))
    by_case = {}
    for name, ins in sass.items():
        if "noise_kernel" in name:
            by_case[int(template_args(name)[0])] = ins
    table = {}
    for i, case in enumerate(noise_micro.CASES):
        outside, inside = split_regions(by_case[i])
        table[case] = counts(outside)
        print(f"{case}: integer {table[case][0]}, float {table[case][1]} "
              f"(counted outside the regions; inside: integer, float "
              f"{counts(inside)}); outside: "
              + ", ".join(f"{k} {v}" for k, v in
                          Counter(outside).most_common())
              + "; inside: " + ", ".join(
                  f"{k} {v}" for k, v in Counter(inside).most_common()),
              flush=True)
    print("OPS = {" + ", ".join(f'"{c}": {v}' for c, v in table.items())
          + "}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
