#!/usr/bin/env python3
"""Write ``bflbm_tpu_torch/kernels/csrc/lattice_tables.cuh``: the D3Q19
velocities C, the moment matrix M and its inverse M_INV, the gradient
weights w_i / cs^2 and the laplacian's weights w_i, their sum over
i >= 1 and 2 / cs^2 of ``bflbm_tpu_torch/lattice.py`` as compile-time
constants of device code (the float32 values the kernels'
``__constant__`` tables and the laplacian pre-pass's arguments hold, as
exact hexadecimal literals).

    python tools/gen_lattice_tables.py          # rewrite the header
    python tools/gen_lattice_tables.py --check  # exit 1 if it is stale
"""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "bflbm_tpu_torch" / "kernels" / "csrc" / "lattice_tables.cuh"


def _array(name, ctype, table, fmt):
    rows, cols = table.shape
    lines = [f"__device__ const {ctype} {name}[{rows}][{cols}] = {{"]
    for r in range(rows):
        vals = ", ".join(fmt(v) for v in table[r])
        lines.append(f"    {{{vals}}},")
    lines.append("};")
    return "\n".join(lines)


def _vector(name, table, fmt):
    vals = ", ".join(fmt(v) for v in table)
    return f"__device__ const float {name}[{len(table)}] = {{{vals}}};"


def _float(v):
    return float(np.float32(v)).hex() + "f"


def render() -> str:
    sys.path.insert(0, str(ROOT))
    from bflbm_tpu_torch.lattice import C, CS2, M, M_INV, W

    return "\n".join([
        "// Generated by tools/gen_lattice_tables.py from",
        "// bflbm_tpu_torch/lattice.py; do not edit.  The D3Q19 tables as",
        "// constant device arrays with their values known to the compiler:",
        "// read at indices known after unrolling, each read folds to an",
        "// immediate operand (the float32 values of the __constant__ tables",
        "// that bflbm_set_tables fills).",
        "",
        "#pragma once",
        "",
        "namespace {",
        "",
        "// kLatC[i][d]: component d of velocity c_i",
        _array("kLatC", "int", np.asarray(C, np.int32), lambda v: str(int(v))),
        "",
        "// kLatM[k][i]: row k of the moment transform M",
        _array("kLatM", "float", np.asarray(M, np.float32), _float),
        "",
        "// kLatMinv[i][k]: M_INV, the back transform",
        _array("kLatMinv", "float", np.asarray(M_INV, np.float32), _float),
        "",
        "// kLatGW[i]: w_i / cs^2, the weights of the isotropic gradient",
        _vector("kLatGW", np.asarray(W / CS2, np.float32), _float),
        "",
        "// kLatW[i]: w_i, and kLatWSum = sum_{i>=1} w_i, kLatTwoCs2 = 2 / cs^2:",
        "// the laplacian's weights (csrc/laplacian_psi.cu, lap_ext1's float32",
        "// values)",
        _vector("kLatW", np.asarray(W, np.float32), _float),
        "constexpr float kLatWSum = "
        + _float(sum(float(w) for w in W[1:])) + ";",
        "constexpr float kLatTwoCs2 = " + _float(2.0 / CS2) + ";",
        "",
        "}  // namespace",
        "",
    ])


def main(argv) -> int:
    text = render()
    if "--check" in argv:
        return 0 if HEADER.read_text() == text else 1
    HEADER.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
