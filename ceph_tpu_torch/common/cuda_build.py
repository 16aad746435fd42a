"""Build the port's CUDA C++ sources and load them with ctypes.

Each ``csrc/*.cu`` file exports plain C functions (pointers and the stream
as ``void*``, returning ``cudaGetLastError()``), so it compiles in seconds
without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

Libraries land in ``ceph_tpu_torch/_build/`` (listed in .gitignore), named by
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing builds at import time: the first
kernel launch builds its library, and ``build()`` starts every missing
source's nvcc at once for callers that want the build up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
# csrc/<name>.cu, one library each
SOURCES = ("gf2_apply", "gf2_variants", "gf2_grouped", "lab_copy",
           "lab_bits")
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the
    toolkit's default location.  Raises when none exists."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(pathlib.Path(os.environ[env]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(pathlib.Path(found))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> pathlib.Path:
    """Where csrc/<name>.cu builds to (content-addressed: the source, the
    shared csrc/*.cuh headers and the flags)."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names) -> dict[str, float]:
    """Compile every csrc/<name>.cu whose library is missing, all nvcc
    processes started together.  Returns wall seconds per compiled name
    (0.0 when the library already existed); raises with nvcc's output on
    a failed compile.  Each compile's output (ptxas register and shared
    memory report) is kept beside the library as <lib>.log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    errors = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(rc={proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        target.with_suffix(".so.log").write_text(out)
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def build_log(name: str) -> str:
    """The compiler output kept from building csrc/<name>.cu ("" if the
    library was built without one)."""
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = library_path(name)
            if not target.exists():
                build([name])
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib
