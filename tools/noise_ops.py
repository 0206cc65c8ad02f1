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

What is counted is the fast path, the instructions a thread of an
in-range cell issues on the shortest way from the kernel's entry to its
EXIT: a predicated EXIT falls through (the range guard), a predicated
branch may go either way, a call (``CALL.REL``: the libm slow paths,
``sqrtf``'s for special inputs) and the blocks placed after the last
EXIT (reached only by a branch) are never taken.  The Box-Muller cases
(``hash_u16``, ``hash_1mul24``, ``hash_1mul16``, ``hash_nomul``,
``philox``) then count their ``logf`` (predicated, branch-free), the
fast ``sincosf`` (the Payne-Hanek reduction for |x| >= 105615 skipped:
the angle 2 pi u is below 6.3) and the fast ``sqrtf`` of every pair; the
straight-line cases count all their code.  Predicated instructions count
where they are issued, whether their predicate holds or not.
Instructions of other pipes (conversions, MUFU, VIADD, FSETP / FSEL,
memory, control) bound nothing here, so the counts give a lower bound on
the time.

Prints one line a case (the counts, then every opcode on the path) and,
last, ``probes/noise_micro.py``'s ``OPS`` table of (integer, float)
pairs.  Needs the card (it builds the library) and ``cuobjdump`` (the
CUDA toolkit).

    PYTHONPATH=. python tools/noise_ops.py
"""

import heapq
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


def fast_path(instructions):
    """The opcodes of the shortest way through a kernel's SASS (its
    instruction texts, 16 bytes each from address 0) from its entry to
    an unconditional EXIT, under the module's rules (a Dijkstra walk,
    every instruction one)."""
    ops = [opcode(t) for t in instructions]
    last_exit = max(i for i, t in enumerate(instructions)
                    if ops[i].startswith("EXIT") and not t.startswith("@"))

    def successors(i):
        text = instructions[i]
        base = ops[i].split(".")[0]
        pred = text.startswith("@")
        if base == "EXIT":
            return [i + 1] if pred else []
        if base == "BRA":
            to = int(re.search(r"0x([0-9a-f]+)\s*$", text).group(1), 16)
            return [to // 16, i + 1] if pred else [to // 16]
        if base in ("CALL", "JMP", "BRX", "RET"):
            return [i + 1] if pred else None
        return [i + 1]

    dist, prev, heap = {0: 1}, {0: None}, [(1, 0)]
    while heap:
        d, i = heapq.heappop(heap)
        if d > dist[i]:
            continue
        nxt = successors(i)
        if nxt == []:
            path = []
            while i is not None:
                path.append(ops[i])
                i = prev[i]
            return path[::-1]
        for j in nxt or ():
            if j <= last_exit and d + 1 < dist.get(j, d + 2):
                dist[j], prev[j] = d + 1, i
                heapq.heappush(heap, (d + 1, j))
    raise ValueError("no path to an EXIT")


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
        path = fast_path(by_case[i])
        table[case] = counts(path)
        print(f"{case}: integer {table[case][0]}, float {table[case][1]} "
              f"({len(path)} instructions on the fast path of "
              f"{len(by_case[i])}): "
              + ", ".join(f"{k} {v}" for k, v in
                          Counter(path).most_common()), flush=True)
    print("OPS = {" + ", ".join(f'"{c}": {v}' for c, v in table.items())
          + "}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
