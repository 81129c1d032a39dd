#!/usr/bin/env python3
"""
Where a launch's time goes in the general-T forward kernel with the T planes
in device memory (whatshap_torch/csrc/wmec_forward_t_wide.cu, kernel row 14),
on one CUDA card:

    python3 profile_forward_t_wide.py [--parent DIR]

The card's profilers are not at hand, so this builds variants of the kernel
source under build/whatshap_torch/parts_wide/, each with parts switched off
(their results are wrong and are not used), and times them with CUDA events
against the unchanged kernel at one launch of phase-cli-fam5's bucket of
most work (wide-t64: the blocks of 64 columns at K = 15, T = 64, P = 4 one
launch takes under the table budget), in the tables mode (seeded, as pass 2
runs it) and the m-only mode (pass 1: the 16 coset seeds of each block), in
two rounds.  A part's cost is the difference to the unchanged kernel.  With
--parent DIR the same parts of the kernel of the checkout in DIR are timed
too (its m-only mode over the blocks repeated once per seed, as its route
ran it), in turns with this one's: parent, kernel, kernel, parent.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from whatshap_torch.ops import _build, wmec, wmec_cuda
from whatshap_torch.parallel import blocks

SOURCE = "wmec_forward_t_wide"
#: variant -> (text in this checkout's source, its replacement)
VARIANTS = {
    "kernel": [],
    "no fold": [("const int nf = meta[64];", "const int nf = 0;")],
    "no min-plus": [("for (int j = 0; j < a.lt; j += 3) {", "for (int j = 0; j < 0; j += 3) {")],
    "no column cost": [("tile_cost<P>(l, sm, a.acost + (col * T << P), T);", "")],
    "no table writes": [("__stcs(a.pidx + tab, xi[e]);", ""), ("__stcs(a.pjmin + tab, (int)xj[e]);", "")],
}
VARIANTS["loads and stores only"] = [s for k in ("no fold", "no min-plus", "no column cost") for s in VARIANTS[k]]
#: the same parts in the source of the kernel's first draft (a checkout before the redesign)
PARENT_VARIANTS = {
    "kernel": [],
    "no fold passes": [("for (int p = 0; p < np; ++p) {", "for (int p = 0; p < 0; ++p) {")],
    "no min-plus": [("for (int j = 0; j < a.lt; ++j) {", "for (int j = 0; j < 0; ++j) {")],
    "no column cost": [
        ("for (int g = 1; g < (1 << P); ++g) {", "for (int g = 1; g < 1; ++g) {"),
        ("for (uint32_t bits = (uint32_t)sl; bits != 0; bits &= bits - 1) {",
         "for (uint32_t bits = 0; bits != 0; bits &= bits - 1) {"),
    ],
    "no table writes": [("__stcs(row + s, iv[e]);", ""), ("__stcs(a.pjmin + row_at + s, jv);", ""),
                        ("if (kTab && !folded) {", "if (false) {")],
}
PARENT_VARIANTS["passes' loads and stores only"] = [
    s for k in ("no min-plus", "no column cost") for s in PARENT_VARIANTS[k]]
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"wmec_forward_t_wide": [_P] * 16 + [_I] * 5 + [_P],
              "wmec_forward_m_t_wide": [_P] * 9 + [_I] * 6 + [_P]}
PARENT_SIGNATURES = {"wmec_forward_t_wide": [_P] * 16 + [_I] * 5 + [_P],
                     "wmec_forward_m_t_wide": [_P] * 9 + [_I] * 5 + [_P]}


def build_variants(src: str, variants: dict, signatures: dict, tag: str) -> dict:
    """Build each variant of the source text `src` (its substitutions
    applied) under build/whatshap_torch/parts_wide/<tag>/, one nvcc each, all
    started together; returns {variant: the loaded library}."""
    out = _build.BUILD_DIR / "parts_wide" / tag
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
        text = src
        for a, b in subs:
            if a not in text:
                raise RuntimeError(f"variant {name!r}: {a!r} is not in the source")
            text = text.replace(a, b)
        cu = out / f"part{i}.cu"
        cu.write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out / f"part{i}.so"), str(cu)]
        procs[name] = (out / f"part{i}.so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                             text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name!r}:\n{log}")
        if name == "kernel":
            print(f"{tag}: " + "; ".join(x.strip() for x in log.splitlines() if "registers" in x or "spill" in x),
                  flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, sig in signatures.items():
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def fam5_bucket():
    """wide-t64: one launch of phase-cli-fam5's bucket of most work as the
    route chunks it, the arrays on the card, and the block's coset seeds."""
    with tempfile.TemporaryDirectory() as tmp:
        data = cs.write_synth(f"{tmp}/fam5", cs.FAM5_VARIANTS, 5, seed=17, trio=True, children=3)
        _l, packed, _w, _r = cs.cli_instance(data, "phase-cli-fam5", (), plain=False, ped=data["ped"])
    (c_pad, K), members, _ri = cs.main_bucket(packed)
    T, P = packed.T, packed.P
    per_block = c_pad * (T * 8 << K) + wmec_cuda.state_bytes(K, T, P)
    members = members[: max(1, wmec._table_budget(torch.device("cuda")) // per_block)]
    arrays = blocks.to_device(blocks.stack_blocks(members), "cuda")
    _rep_of, reps = wmec.coset_representatives(T, packed.t_sym_masks)
    R = len(reps)
    unit = np.full((R, T), wmec.INF, dtype=np.int32)
    unit[np.arange(R), reps] = 0
    seeds = torch.from_numpy(unit).to("cuda").expand(len(members), R, T).contiguous()
    return K, T, P, arrays, seeds


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_forward_t_wide: no CUDA device available", file=sys.stderr)
        return 1
    parent = Path(sys.argv[sys.argv.index("--parent") + 1]) if "--parent" in sys.argv else None
    libs = {"": build_variants((_build.CSRC / f"{SOURCE}.cu").read_text(), VARIANTS, SIGNATURES, "kernel")}
    if parent is not None:
        src = (parent / "whatshap_torch" / "csrc" / f"{SOURCE}.cu").read_text()
        libs["parent "] = build_variants(src, PARENT_VARIANTS, PARENT_SIGNATURES, "parent")
    K, T, P, arrays, seeds = fam5_bucket()
    B, C, S = arrays[0].shape[0], arrays[0].shape[1], 1 << K
    R = seeds.shape[1]
    dp0 = seeds[:, 0].contiguous()
    dev = "cuda"
    pidx = torch.empty((B, C, T, S), dtype=torch.int32, device=dev)
    pjmin = torch.empty_like(pidx)
    dp = torch.empty((B, T, S), dtype=torch.int32, device=dev)
    jm = torch.empty_like(dp)
    key = torch.empty((B, S), dtype=torch.int32, device=dev)
    m = torch.empty((B * R, T), dtype=torch.int32, device=dev)
    planes = torch.empty((B * R, T, S), dtype=torch.int32, device=dev)
    scratch = torch.empty(B * R * C + C, dtype=torch.int32, device=dev)
    ins = [a.data_ptr() for a in arrays]
    stream = torch.cuda.current_stream().cuda_stream
    rep_ptrs = None
    if parent is not None:
        rep = [a.repeat_interleave(R, dim=0) for a in arrays]
        rep_ptrs = ([a.data_ptr() for a in rep], rep)
    wd, wb, _rw, ac, die, rc = ins

    def runs(tag):
        tables = lambda lib: lib.wmec_forward_t_wide(  # noqa: E731
            *ins, dp0.data_ptr(), None, None, None, pidx.data_ptr(), pjmin.data_ptr(), dp.data_ptr(),
            jm.data_ptr(), key.data_ptr(), scratch.data_ptr(), B, C, K, T, P, stream)
        if tag:
            rwd, rwb, _rrw, rac, rdie, rrc = rep_ptrs[0]
            m_only = lambda lib: lib.wmec_forward_m_t_wide(  # noqa: E731
                rwd, rwb, rac, rdie, rrc, seeds.data_ptr(), m.data_ptr(), planes.data_ptr(), scratch.data_ptr(),
                B * R, C, K, T, P, stream)
        else:
            m_only = lambda lib: lib.wmec_forward_m_t_wide(  # noqa: E731
                wd, wb, ac, die, rc, seeds.data_ptr(), m.data_ptr(), planes.data_ptr(), scratch.data_ptr(),
                B, C, K, T, P, R, stream)
        return {"tables": tables, "m-only": m_only}

    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{power}; wide-t64: B={B} C={C} K={K} T={T} P={P}, R={R} seeds a block", flush=True)
    order = list(libs) + list(reversed(libs))
    for rnd, tag in enumerate(order):
        for mode, run in runs(tag).items():
            for name, lib in libs[tag].items():
                if run(lib) != 0:
                    raise RuntimeError(f"{tag}{name} {mode}: launch failed")
                ms = cs._time(lambda: run(lib), reps=2)
                print(f"turn {rnd} {tag}{name:30s} {mode:7s} {ms:10.3f} ms {ms * 1e3 / C:9.2f} us per column",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
