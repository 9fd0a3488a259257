#!/usr/bin/env python3
"""Atomic instructions in the compiled SASS of the port's CUDA kernels.

Run from the repository root on a machine with nvcc (a GPU is not needed
to build, only the CUDA toolkit):

    python3 scripts/torch_sass_atomics.py [--port DIR] [--kernels REGEX]

It builds (or reuses) the kernel library of the checkout DIR (default:
this one; ops/cuda_lib.py), dumps its SASS with the toolkit's cuobjdump,
and for each kernel function whose mangled name matches REGEX prints one
JSON line: the count of every atomic or reduction opcode in it (shared
ATOMS, global ATOM / ATOMG / RED, with their type suffixes; a 64-bit
shared add that compiles to a compare-and-swap loop shows as
ATOMS.CAST.SPIN.64), and of DADD, the f64 adds, with ptxas's registers
and spills for it when this process built the library. The last line is
one JSON object with the library's path and the function count.
"""
import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# an instruction line of cuobjdump -sass: /*addr*/ [@P] OPCODE ...
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)")


def sass_functions(text: str):
    """{mangled function name: [opcodes]} of a cuobjdump -sass listing."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is not None:
            m = _INSN.search(line)
            if m:
                cur.append(m.group(1))
    return funcs


def ptxas_info(log: str):
    """{mangled entry name: [ptxas lines]} of an nvcc -Xptxas -v log."""
    info, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = info.setdefault(m.group(1), [])
        elif cur is not None and ("registers" in line or "spill" in line):
            cur.append(line.strip())
    return info


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", default=HERE)
    ap.add_argument("--kernels", default=".")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_ab_train import load_port
    cuda_lib = load_port(args.port, "lightgbm_tpu_torch_sass").ops.cuda_lib
    cuda_lib.load()
    lib = str(cuda_lib.BUILD_INFO["path"])
    tool = os.path.join(os.path.dirname(cuda_lib.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs = sass_functions(text)
    ptxas = ptxas_info(str(cuda_lib.BUILD_INFO.get("log", "")))
    shown = 0
    for name, ops in sorted(funcs.items()):
        if not re.search(args.kernels, name):
            continue
        counts = {}
        for op in ops:
            if op.startswith(("ATOM", "RED")) or op == "DADD":
                counts[op] = counts.get(op, 0) + 1
        print(json.dumps(dict(function=name, instructions=len(ops),
                              atomics_and_dadd=counts,
                              ptxas=ptxas.get(name))))
        shown += 1
    print(json.dumps(dict(library=lib, port=os.path.abspath(args.port),
                          functions=len(funcs), shown=shown)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
