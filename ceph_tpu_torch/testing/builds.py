"""Builds of the port's kernels on the card, side by side: what
``testing/split2_builds.py`` and ``testing/copy_builds.py`` share.

A build is the committed ``csrc/`` with named text edits applied to a copy:
a list of ``(file in csrc/, old text, new text)``, each old text present
once in its file.  ``compile_builds`` writes each build's copy into its own
directory and compiles one of its sources as ``cuda_build`` compiles (nvcc,
the same flags), all nvcc processes started at once; ``one_kernel`` picks a
kernel's ptxas registers and spills out of the compile's output; and
``interleaved`` times labelled launches in turn, forward then backward, so
that a drift of the card's clock falls on all alike.  Needs a card and the
CUDA toolkit only where it compiles or times; writes nothing outside the
build directory it is given.
"""

from __future__ import annotations

import functools
import pathlib
import shutil
import subprocess

from ceph_tpu_torch.common import cuda_build
from ceph_tpu_torch.ec import benchmark
from ceph_tpu_torch.testing import sass


def sources(edits, build: str) -> dict[str, str]:
    """csrc file name -> text with ``edits`` applied; raises if an edit's
    old text is not in its file exactly once."""
    files = {p.name: p.read_text() for p in cuda_build.CSRC_DIR.iterdir()
             if p.suffix in (".cu", ".cuh")}
    for name, old, new in edits:
        if files[name].count(old) != 1:
            raise ValueError(f"{build}: edit of {name} does not apply")
        files[name] = files[name].replace(old, new)
    return files


def compile_builds(builds: dict, source: str,
                   build_dir: pathlib.Path) -> dict[str, tuple[str, str]]:
    """build -> (library path, nvcc output) of csrc/<source>.cu under each
    build's edits (``builds``: build -> edits), every nvcc started at
    once; raises with nvcc's output on a failed compile."""
    procs = {}
    for build, edits in builds.items():
        d = build_dir / build
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for name, text in sources(edits, build).items():
            (d / name).write_text(text)
        lib = d / f"{source}.so"
        procs[build] = (lib, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
             str(d / f"{source}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for build, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for build {build}:\n{log}")
        out[build] = (str(lib), log)
    return out


def one_kernel(log: str, label: str, test) -> tuple[str, dict]:
    """The one kernel of a compile whose name passes ``test``, with its
    ptxas registers and spills (``sass.registers``); raises unless exactly
    one does."""
    regs = sass.registers(log)
    names = [n for n in regs if test(n)]
    if len(names) != 1:
        raise AssertionError(f"{label}: kernels {names}")
    return names[0], regs[names[0]]


def interleaved(fns: dict, rounds: int, timer=None) -> dict[str, list[float]]:
    """label -> its ``rounds`` readings, seconds per launch, the labels
    timed in turn, forward in even rounds and backward in odd ones.
    ``timer(fn)`` takes one reading; by default the median over 5 runs of
    CUDA events around 20 launches (``benchmark.cuda_seconds_per_call``)."""
    timer = timer or functools.partial(benchmark.cuda_seconds_per_call,
                                       iterations=20, runs=5)
    got = {label: [] for label in fns}
    order = list(fns)
    for r in range(rounds):
        for label in (order if r % 2 == 0 else order[::-1]):
            got[label].append(timer(fns[label]))
    return got
