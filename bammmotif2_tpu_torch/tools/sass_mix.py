"""The instruction mix of the port's built kernels: each ``__global__``'s
SASS opcodes, counted from ``cuobjdump -sass`` of its library.

    python -m bammmotif2_tpu_torch.tools.sass_mix jax_draws [--kernels cgs_z_kernel ...]

Builds ``csrc/<source>.cu`` as the package does (``ops/_build.py``) and
prints one JSON object: for each kernel whose mangled name holds one of
``--kernels`` (every kernel without it), its static instruction count and
the count of each opcode, both bare (``IMAD``) and with its modifiers
(``IMAD.SHL.U32``).  Static counts: an unrolled loop counts once per copy,
a loop that runs many times counts once.  Needs the CUDA toolkit's
``cuobjdump``; runs no kernel.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess

from bammmotif2_tpu_torch.ops import _build

# an instruction line: /*0a30*/  @!P0 IMAD.SHL.U32 R5, R4, 0x2000, RZ ;
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_FUNCTION = re.compile(r"Function : (\S+)")


def cuobjdump_path() -> str:
    return os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")


def mix(sass: str, kernels=None) -> dict:
    """{mangled kernel name: {"instructions": n, "opcodes": {op: n}}} of
    ``cuobjdump -sass`` output, for the kernels whose names hold one of
    ``kernels`` (all where None)."""
    found, counts = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            keep = kernels is None or any(k in m.group(1) for k in kernels)
            counts = found.setdefault(m.group(1), collections.Counter()) if keep else None
            continue
        m = _INSTR.search(line)
        if m and counts is not None:
            counts[m.group(1)] += 1
    out = {}
    for name, full in found.items():
        ops = collections.Counter(full)
        for op, n in full.items():
            if "." in op:
                ops[op.split(".")[0]] += n
        out[name] = {"instructions": sum(full.values()), "opcodes": dict(sorted(ops.items()))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", help="csrc/<source>.cu")
    ap.add_argument("--kernels", nargs="*", default=None)
    a = ap.parse_args(argv)
    lib = _build.library_path(a.source)
    sass = subprocess.run([cuobjdump_path(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    print(json.dumps(mix(sass, a.kernels)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
