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
"""

import ctypes
import hashlib
import os
import subprocess
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
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((n, out, tmp, proc))
    failed = []
    for n, out, tmp, proc in procs:
        logs[n], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{n} (exit {proc.returncode}):\n{logs[n]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
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
