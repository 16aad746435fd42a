"""Instruction counts of the port's compiled kernels, from their SASS.

    python -m ceph_tpu_torch.testing.sass [source ...]

For each kernel in a built ``csrc/<source>.cu`` library, ``cuobjdump
-sass`` lists the machine code; every backward branch closes a loop, and
the instructions between its target and itself are the loop's body.  The
report gives each loop of more than ``MIN_BODY`` instructions with its
opcode mix: a kernel's inner loop over input rows is the one whose
instruction count, divided by the (word, bit) pairs it handles, gives the
integer instructions per (word, bit).  Needs the CUDA toolkit's cuobjdump.
"""

from __future__ import annotations

import collections
import pathlib
import re
import subprocess
import sys

from ceph_tpu_torch.common import cuda_build

MIN_BODY = 60

_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")


def cuobjdump_path() -> str:
    return str(pathlib.Path(cuda_build.nvcc_path()).parent / "cuobjdump")


def loops(sass: str) -> dict[str, list[tuple[int, dict[str, int]]]]:
    """kernel name -> [(body length, opcode counts)] of each loop longer
    than MIN_BODY instructions, in address order."""
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name = chunk.splitlines()[0].strip()
        insns = [(int(m.group(1), 16), m.group(2))
                 for m in map(_INSN.match, chunk.splitlines()) if m]
        found = []
        for addr, text in insns:
            br = _BRA.search(text)
            if not br or int(br.group(1), 16) >= addr:
                continue
            body = [t for a, t in insns if int(br.group(1), 16) <= a <= addr]
            if len(body) > MIN_BODY:
                ops = collections.Counter(
                    re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
                    for t in body)
                found.append((len(body), dict(ops.most_common(8))))
        out[name] = found
    return out


def kernel_loops(source: str) -> dict[str, list[tuple[int, dict[str, int]]]]:
    """``loops`` of a built source's library."""
    sass = subprocess.run(
        [cuobjdump_path(), "-sass", str(cuda_build.library_path(source))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    return loops(sass)


def report(source: str) -> list[str]:
    """One line per (kernel, loop) of a built source's library."""
    return [f"{source}: {name}: loop of {n} instructions {ops}"
            for name, found in kernel_loops(source).items()
            for n, ops in found]


def main(argv=None) -> int:
    sources = (argv if argv is not None else sys.argv[1:]) \
        or list(cuda_build.SOURCES)
    cuda_build.build(sources)
    for source in sources:
        for line in report(source):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
