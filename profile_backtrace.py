#!/usr/bin/env python3
"""
The card's dependent-gather latency, and where the backtraces' time goes
(whatshap_torch/csrc/wmec_backtrace_t1.cu and wmec_backtrace_t.cu over
csrc/wmec_walk.cuh), on one CUDA card:

    python3 profile_backtrace.py [--parent DIR]

A pointer-chase probe (one thread, v <- table[c, v] from the last column to
the first over a random table of the walk's shape: the first-draft walk) is
built under build/whatshap_torch/probe/ and timed with CUDA events; its time
over the columns is the latency of one dependent gather: from L1, from L2
and from device memory (a new path through a table far beyond L2 each run).
Then variants of the backtrace sources, each with one choice changed (the
lanes of row 0, the guessed rows), are built under
build/whatshap_torch/parts_bt/ and timed against the unchanged kernels in
two rounds, warm (each run retraces the walk the warm-up brought into L2)
and from a flushed L2, at the shapes the cells launch the walks at: the
single block (B = 1, C = 4096, K = 15), a T = 1 segment (B = 1, C = 2048),
the slice's bucket (B = 256, C = 512), the trio's bucket (320 walks of 256
columns, T = 4) and the trio-single range (T = 4, B = 1, C = 2048); each
variant's walk must equal the kernel's.  A "clocks" variant sums clock64()
over a round's parts (its results are wrong).  With --parent DIR, the
backtraces of the checkout in DIR (built from its sources; their C entries
take no masks) are timed instead in turns with this one's: parent, kernel,
kernel, parent.
"""

import ctypes
import subprocess
import sys

import torch

import chip_smoke as cs
from whatshap_torch.ops import _build, wmec, wmec_cuda
from whatshap_torch.parallel import blocks

PROBE = r"""
#include <cuda_runtime.h>
__global__ void chase(const int* __restrict__ table, int C, int K, int v, int* out) {
  for (int c = C - 1; c >= 0; --c) v = __ldg(table + ((size_t)c << K) + v);
  *out = v;
}
extern "C" int gather_chase(const int* table, int C, int K, int v, int* out, cudaStream_t s) {
  chase<<<1, 1, 0, s>>>(table, C, K, v, out);
  return (int)cudaGetLastError();
}
"""

_PROBE = []


def _probe_lib():
    if not _PROBE:
        out = _build.BUILD_DIR / "probe"
        out.mkdir(parents=True, exist_ok=True)
        (out / "gather_chase.cu").write_text(PROBE)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "gather_chase.so"), str(out / "gather_chase.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the probe:\n{proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(str(out / "gather_chase.so"))
        lib.gather_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]
        lib.gather_chase.restype = ctypes.c_int
        _PROBE.append(lib)
    return _PROBE[0]


def gather_latency_ns(C: int, K: int, cold: bool, reps: int = 5, seed: int = 0) -> float:
    """Nanoseconds of one dependent gather on the card: a chase through C
    columns of a random (C, 2^K) int32 table, by CUDA events.  cold: each
    run starts from another index, so that it meets no line an earlier run
    brought into the caches; else every run retraces the warm-up's path."""
    lib = _probe_lib()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randint(0, 1 << K, (C, 1 << K), dtype=torch.int32, device="cuda", generator=gen)
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    start = [0]

    def run():
        if lib.gather_chase(table.data_ptr(), C, K, start[0], out.data_ptr(), stream) != 0:
            raise RuntimeError("gather_chase: launch failed")
        start[0] = (start[0] + 1) % (1 << K) if cold else start[0]

    ms = cs._time(run, reps=reps)
    del table
    return ms * 1e6 / C


def latencies() -> dict:
    """The dependent-gather latency from L2 (a path of 16,384 lines, more
    than L1 holds, retraced through an 8 MiB table) and from device memory
    (a new path through a 512 MiB table each run, the single block's table
    size at K = 15)."""
    return {"L2": gather_latency_ns(16384, 7, cold=False), "HBM": gather_latency_ns(4096, 15, cold=True)}


#: variant -> (text in the walk header or a backtrace source, its
#: replacement); every variant keeps the results
ROW0 = "{ return t1 ? 6 : (wide ? 3 : 8); }"


def layout(t1=6, narrow=8, wide=3):
    """Substitutions setting the lanes of row 0: at T = 1, and at T > 1 in a
    narrow and in a wide launch."""
    return [(ROW0, f"{{ return t1 ? {t1} : (wide ? {wide} : {narrow}); }}")]


#: clock64() around a round's parts, summed over the walk and written by
#: lane 0 over path[0:3] of its walk (its results are wrong): until the
#: gathers are issued; from there until row 0's ballot has its data; the
#: whole walk
CLOCKS = [
    ("  int c = C - 1;\n", "  int c = C - 1;\n  long long ck0 = 0, ck1 = 0, t0 = 0, t1 = 0, tw = clock64();\n"),
    ("  while (c >= 0) {\n", "  while (c >= 0) {\n    t0 = clock64();\n"),
    ("    // ---- row 0's columns up to", "    t1 = clock64(); ck0 += t1 - t0;\n    // ---- row 0's columns up to"),
    ("    const int n0 = ch0 ?", "    ck1 += clock64() - t1;\n    const int n0 = ch0 ?"),
    ("  if (!kT1 && chk_col >= 0) {\n    const int got",
     "  if (lane == 0) path[0] = (int)ck0, path[1] = (int)ck1, path[2] = (int)(clock64() - tw);\n"
     "  if (!kT1 && chk_col >= 0) {\n    const int got"),
]

#: variant -> (text in the walk header or a backtrace source, its
#: replacement); every variant but the clocks keeps the results.  Each
#: layout variant changes one of the four layouts, so it moves only the
#: shapes that take that layout.
VARIANTS = {
    "kernel": [],
    "clocks (wrong)": CLOCKS,
    "T=1: no guessed rows": [("constexpr int kGuesses = 4;", "constexpr int kGuesses = 0;")],
    "T=1: row 0 of 4": layout(t1=4),
    "T=1: row 0 of 8": layout(t1=8),
    "T>1 narrow: row 0 of 6": layout(narrow=6),
    "T>1 narrow: row 0 of 12": layout(narrow=12),
    "T>1 wide: row 0 of 2": layout(wide=2),
    "T>1 wide: row 0 of 4": layout(wide=4),
}
SOURCES = ("wmec_walk.cuh", "wmec_backtrace_t1.cu", "wmec_backtrace_t.cu")


def build_variants(names=None):
    """Build each variant of both backtrace sources (with the walk header
    beside them, the variant's substitutions applied to all three) under
    build/whatshap_torch/parts_bt/, one nvcc each, all started together.
    Returns {variant: {entry: library}}."""
    texts = {f: (_build.CSRC / f).read_text() for f in SOURCES}
    out = _build.BUILD_DIR / "parts_bt"
    nvcc = _build._nvcc()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        if names is not None and name not in names:
            continue
        d = out / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        var = dict(texts)
        for a, b in subs:
            hits = [f for f in SOURCES if a in var[f]]
            if not hits:
                raise RuntimeError(f"variant {name!r}: {a!r} is in no source")
            for f in hits:
                var[f] = var[f].replace(a, b)
        for f, text in var.items():
            (d / f).write_text(text)
        for src in ("wmec_backtrace_t1", "wmec_backtrace_t"):
            cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(d / f"{src}.so"), str(d / f"{src}.cu")]
            procs[(name, src)] = (d / f"{src}.so", subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, src), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r} {src}:\n{log}")
        lib = ctypes.CDLL(str(so))
        getattr(lib, src).argtypes = wmec_cuda._SIGNATURES[src]
        getattr(lib, src).restype = ctypes.c_int
        libs.setdefault(name, {})[src] = lib
    return libs


def shapes():
    """(label, T, K, tables, start, die) at the shapes the cells launch the
    walks at: the single block, a T = 1 segment (the tables from the carry
    after segment 0), the slice's bucket, the trio's bucket (pass 2's head
    and seam walks over tables seeded with zeros) and the trio-single
    range."""
    out = []
    rs, pos, _t = cs.chromosome(1, 4096, 15, seed=3)
    single = wmec.pack_problem(rs, [1] * len(pos), cs._het_pedigree(len(pos)), False)
    rs, pos, _t = cs.chromosome(256, 512, 15, seed=7)
    sl = wmec.pack_problem(rs, [1] * len(pos), cs._het_pedigree(len(pos)), False)
    for label, packed in (("single", single), ("slice", sl)):
        (c_pad, K), members, _ri = cs.main_bucket(packed)
        arrays = blocks.to_device(blocks.stack_blocks(members), "cuda")
        pidx, dp, key = wmec_cuda.forward_t1(K, 2, *arrays)
        opt = wmec_cuda._select_optimum(K, 1, dp, key)[2].contiguous()
        out.append((label, 1, K, (pidx,), opt, wmec_cuda.pack_die(arrays[4])))
        if label == "single":
            seg = [a[:, 2048:].contiguous() for a in arrays]
            carry = wmec_cuda.forward_t1(K, 2, *[a[:, :2048].contiguous() for a in arrays])[1:]
            pidx, dp, key = wmec_cuda.forward_t1(K, 2, *seg, carry=carry)
            opt = wmec_cuda._select_optimum(K, 1, dp, key)[2].contiguous()
            out.append(("T=1 segment", 1, K, (pidx,), opt, wmec_cuda.pack_die(seg[4])))
        del arrays
    rs, pos, ped, _truth = cs.simulate_pedigree(64, 256, 5, cs.TRIO, seed=11)
    packed = wmec.pack_problem(rs, [10] * len(pos), ped, False, pos)
    (c_pad, K), members, _ri = cs.main_bucket(packed)
    arrays = blocks.to_device(blocks.stack_blocks(members), "cuda")
    B, T = len(members), packed.T
    kern = wmec_cuda.forward_t(K, T, packed.P, *arrays, torch.zeros((B, T), dtype=torch.int32, device="cuda"))
    inits = cs._walk_inits(K, T, kern, torch.ones((B, K), dtype=torch.bool, device="cuda"))
    out.append(("trio bucket", T, K, kern[:2], inits, wmec_cuda.pack_die(arrays[4])))
    del kern, arrays
    rs, pos, ped, _truth = cs.simulate_pedigree(1, 2048, 5, cs.TRIO, seed=5)
    packed = wmec.pack_problem(rs, [10] * len(pos), ped, False, pos)
    (c_pad, K), members, _ri = cs.main_bucket(packed)
    arrays = blocks.to_device(blocks.stack_blocks(members), "cuda")
    kern = wmec_cuda.forward_t(K, packed.T, packed.P, *arrays)
    init = wmec_cuda._head_init(K, packed.T, *kern[2:])[1][:, None].contiguous()
    out.append(("trio-single", packed.T, K, kern[:2], init, wmec_cuda.pack_die(arrays[4])))
    return out


def build_parent(root):
    """Build the two backtrace sources of another checkout (its csrc, with
    its headers) under build/whatshap_torch/parts_bt/parent/.  Their C
    entries take no masks, as before the masks were added: returns
    {entry: library} with the entries bound to those signatures."""
    import shutil
    from pathlib import Path

    src = Path(root) / "whatshap_torch" / "csrc"
    d = _build.BUILD_DIR / "parts_bt" / "parent"
    d.mkdir(parents=True, exist_ok=True)
    for f in src.glob("*.cuh"):
        shutil.copy(f, d / f.name)
    libs, procs = {}, {}
    for name in ("wmec_backtrace_t1", "wmec_backtrace_t"):
        shutil.copy(src / f"{name}.cu", d / f"{name}.cu")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{name}.so"), str(d / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    sigs = {"wmec_backtrace_t1": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            "wmec_backtrace_t": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{log}")
        lib = ctypes.CDLL(str(d / f"{name}.so"))
        getattr(lib, name).argtypes = sigs[name]
        getattr(lib, name).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    """Usage: python3 profile_backtrace.py [--parent DIR]: with --parent, the
    backtraces of the checkout in DIR (built from its sources) are timed in
    turns with this one's (parent, kernel, kernel, parent) at every shape."""
    if not torch.cuda.is_available():
        print("profile_backtrace: no CUDA device available", file=sys.stderr)
        return 1
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    print(power, flush=True)
    for C, K, cold, where in ((1024, 3, False, "a path of 1,024 lines retraced, 32 KiB table (L1)"),
                              (16384, 7, False, "a path of 16,384 lines retraced, 8 MiB table (L2)"),
                              (16384, 7, True, "a new path each run, 8 MiB table (L2)"),
                              (1024, 15, True, "a new path each run, 128 MiB table"),
                              (4096, 15, True, "a new path each run, 512 MiB table"),
                              (4096, 15, False, "a path retraced, 512 MiB table")):
        print(f"gather latency, {where} (C={C}, K={K}): {gather_latency_ns(C, K, cold):.1f} ns", flush=True)
    parent = build_parent(sys.argv[sys.argv.index("--parent") + 1]) if "--parent" in sys.argv else None
    libs = build_variants(None if parent is None else ["kernel"])
    stream = torch.cuda.current_stream().cuda_stream
    for label, T, K, tables, start, die in shapes():
        B, C = tables[0].shape[0], tables[0].shape[1]
        W = start.numel() if T == 1 else start.shape[0] * start.shape[1]
        path = torch.empty((W, C), dtype=torch.int32, device="cuda")
        tpath = torch.empty_like(path)
        final = torch.empty((W, 3), dtype=torch.int32, device="cuda")

        def run(lib, masks=True, T=T, K=K, tables=tables, start=start, die=die, B=B, C=C, path=path,
                tpath=tpath, final=final):
            d = [die.data_ptr()] if masks else []
            if T == 1:
                err = lib["wmec_backtrace_t1"].wmec_backtrace_t1(
                    start.data_ptr(), tables[0].data_ptr(), *d, path.data_ptr(), final.data_ptr(), B, C, K, stream)
            else:
                err = lib["wmec_backtrace_t"].wmec_backtrace_t(
                    start.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(), *d, path.data_ptr(),
                    tpath.data_ptr(), final.data_ptr(), B, start.shape[1], C, T, K, stream)
            if err != 0:
                raise RuntimeError(f"{label}: launch failed ({err})")

        run(libs["kernel"])
        torch.cuda.synchronize()
        ref = (path.clone(), tpath.clone(), final.clone())
        out = (path.view(B, -1, C), tpath.view(B, -1, C), final.view(B, -1, 3)) if T > 1 else (path, final.view(-1)[:B])
        rounds = cs.walk_rounds(T, out, die) / C
        print(f"{label}: T={T} K={K} walks={W} C={C}: {rounds:.3f} round trips a column", flush=True)
        order = [(n, lib, True) for n, lib in libs.items()]
        if parent is not None:
            order = [("parent", parent, False), ("kernel", libs["kernel"], True)]
            order += order[::-1]
        for rnd in range(2 if parent is None else 1):
            for name, lib, masks in order:
                run(lib, masks)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip((path, tpath, final), ref))
                ms = cs._time(lambda: run(lib, masks), reps=10)
                cold = cs._time_cold(lambda: run(lib, masks), reps=10)
                print(f"round {rnd} {label:12s} {name:30s} {ms:8.4f} ms ({ms * 1e6 / C:7.1f} ns a column), "
                      f"{cold:8.4f} ms from a flushed L2 ({cold * 1e6 / C:7.1f} ns a column)"
                      f"{'' if same else ' RESULT DIFFERS'}", flush=True)
                if name.startswith("clocks"):
                    ck = path[0, :3].tolist()
                    print(f"  clock cycles a column of walk 0: to the gathers {ck[0] / C:.1f}, gathers to row 0's "
                          f"ballot {ck[1] / C:.1f}, walk {ck[2] / C:.1f}", flush=True)
                elif not same:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
