"""
Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source csrc/<name>.cu becomes its own shared library with a plain C
interface, build/whatshap_torch/<name>-<hash>.so at the repository root
(`build/` is git-ignored).  The hash covers the source, the shared headers
and the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is.  build_all() starts one nvcc per source, all at once.  Nothing is
built when this module is imported: the CPU path never needs nvcc.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/whatshap_torch/<name>-<hash>.so csrc/<name>.cu

The host helpers of the read path (csrc/host/<name>.cpp: the BAM pool, the
CIGAR and realignment engine, the edit distances, read selection and the
selection heap) are built the same way with g++ by build_host(), on the CPU
route as on the card's:

    g++ -O3 -shared -fPIC -std=c++17 [extra flags] -o build/whatshap_torch/<name>-<hash>.so csrc/host/<name>.cpp

Each compiler writes to a file of its own process that os.replace moves into
place, so processes that build one library at once all load a whole one.
"""

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "whatshap_torch"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",  # registers, shared memory and spills of each kernel, in the log
]

HOST_CSRC = CSRC / "host"
HOST_SOURCES = ("alignlib", "bamlib", "cigarlib", "readselectlib", "pqext")
GXX = "g++"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Tuple[str, ...]:
    """Names of the kernel sources (csrc/*.cu without the suffix)."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH): "
            "the CUDA kernels of whatshap_torch are built with nvcc"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _build_one(cmd, out: Path):
    """Start one compiler writing a temporary file of this process beside `out`."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    i = cmd.index("-o")
    cmd = [*cmd[: i + 1], str(tmp), *cmd[i + 1 :]]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cmd[0]}: {e}") from e
    return tmp, proc


def _finish(builds, what: str) -> Dict[str, str]:
    """Wait for every build of `builds` ({name: (out, tmp, proc)}), move each
    finished library into place, and raise with the compiler's output if any
    build failed."""
    logs: Dict[str, str] = {}
    failed = []
    for n, (out, tmp, proc) in builds.items():
        logs[n], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{n} (exit {proc.returncode}):\n{logs[n]}")
    if failed:
        raise RuntimeError(f"{what} failed for " + "\n".join(failed))
    return logs


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Tuple[float, Dict[str, str]]:
    """Build every library in `names` (default: all sources) that is not
    built yet, one nvcc process per source, all started together.  Returns
    (wall seconds, {name: nvcc output}); raises if any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in (names or sources()) if not library_path(n).exists()]
    logs: Dict[str, str] = {}
    if not todo:
        return time.perf_counter() - t0, logs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    builds = {}
    for n in todo:
        out = library_path(n)
        builds[n] = (out, *_build_one([nvcc, *NVCC_FLAGS, "-o", str(CSRC / f"{n}.cu")], out))
    logs = _finish(builds, "nvcc")
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def _host_command(name: str):
    """The g++ command of host source `name`, without its output file."""
    extra, libs = [], []
    if name == "cigarlib":
        extra = ["-pthread"]  # the realignment pool's threads
    elif name == "bamlib":
        libs = ["-lz"]  # BGZF inflation
    elif name == "pqext":
        extra = [f"-I{sysconfig.get_paths()['include']}"]  # a CPython extension
    return [GXX, *GXX_FLAGS, *extra, "-o", str(HOST_CSRC / f"{name}.cpp"), *libs]


def host_library_path(name: str) -> Path:
    h = hashlib.sha256((HOST_CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(_host_command(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_host(names: Optional[Iterable[str]] = None) -> Tuple[float, Dict[str, str]]:
    """Build every host library in `names` (default: all of HOST_SOURCES)
    that is not built yet, one g++ process per source, all started together.
    Returns (wall seconds, {name: g++ output}); raises RuntimeError with the
    compiler's output if any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in (names or HOST_SOURCES) if not host_library_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0, {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = {}
    try:
        for n in todo:
            out = host_library_path(n)
            builds[n] = (out, *_build_one(_host_command(n), out))
    finally:
        logs = _finish(builds, "g++")
    return time.perf_counter() - t0, logs
