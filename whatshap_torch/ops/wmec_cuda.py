"""
Hand-written CUDA kernels of the single-sample wMEC solve, with their
wrappers and plain torch versions.

Replaces whatshap_tpu/ops/wmec_pallas.py for T == 1 (one individual, P = 2):

- forward_t1 launches csrc/wmec_forward_t1.cu, the forward column scan that
  replaces _make_kernel in its T=1, table-emitting form (as
  solve_batched_pallas launches it);
- backtrace_t1 launches csrc/wmec_backtrace_t1.cu, the index-path walk that
  replaces _make_backtrace_kernel (via backtrace_pallas);
- _select_optimum picks the tie-broken optimum between them, in torch ops,
  as the JAX side leaves it to XLA;
- solve_batched_cuda is forward -> select -> backtrace, the mirror of
  solve_batched_pallas for T == 1.

A wrapper checks its inputs, then runs its plain torch version on CPU
tensors and its kernel on CUDA tensors; it never falls back from the one to
the other.  `launches` on a wrapper counts its kernel launches, nothing else.
The kernels are built with nvcc at first use (ops/_build.py), never when this
module is imported.
"""

import ctypes

import torch

from . import _build

#: Largest K whose forward state (int32 cost, tie key and projection index,
#: 12 * 2^K bytes) fits one CTA's shared memory (227 KB) on Hopper; above it
#: the state lives in a per-block global scratch.
SMEM_MAX_K = 14
#: Largest K the forward kernel is built and checked for.
MAX_K = 16


def kernel_supported(K: int, T: int, P: int) -> bool:
    """Shapes the CUDA kernels of this module take: one individual (T == 1,
    P == 2) with 1 <= K <= MAX_K slots."""
    return T == 1 and P == 2 and 1 <= K <= MAX_K


def state_bytes(K: int) -> int:
    """Device scratch the forward kernel needs per block beyond its outputs:
    none while the state fits shared memory."""
    return 0 if K <= SMEM_MAX_K else 12 << K


_SIGNATURES = {
    "wmec_forward_t1": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "wmec_backtrace_t1": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def _launch(name: str, *args) -> None:
    """Call the C entry point `name` of the library of the same name on the
    current stream; raise if it reports a CUDA error."""
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        err_fn = getattr(lib, name + "_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = getattr(lib, name + "_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )


def _check_device(*tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def forward_t1_plain(K, P, wdiff, wbase, rankw, acost, die_prev, rc):
    """Plain torch version of the T=1 forward scan: the torch mirror
    (wmec.forward_scan) at T = 1, in forward_t1's output layout."""
    from .wmec import forward_scan

    dp_last, _jmin, key_last, proj_idx, _pj = forward_scan(
        K, 1, P, wdiff, wbase, rankw, acost, die_prev, rc
    )
    return proj_idx[..., 0], dp_last[..., 0], key_last


def forward_t1(K, P, wdiff, wbase, rankw, acost, die_prev, rc):
    """T=1 forward column scan over stacked blocks.

    Inputs as wmec.forward_scan with T = 1: wdiff (B, C, K, 2P) f32, wbase
    (B, C, 1, P, 2) i32, rankw (B, C, K) f32, acost (B, C, 1, 2^P) i32,
    die_prev (B, C, K) bool, rc (B, C) i32 (T = 1 has no recombination term,
    so the kernel does not read it).  Returns pidx (B, C, 2^K), the
    projection table of every column, and the final state dp_last (B, 2^K)
    and key_last (B, 2^K), all int32.
    """
    B, C = wdiff.shape[0], wdiff.shape[1]
    if not kernel_supported(K, 1, P):
        raise ValueError(f"forward_t1: unsupported shape K={K}, P={P}")
    _check(wdiff, "wdiff", torch.float32, (B, C, K, 2 * P))
    _check(wbase, "wbase", torch.int32, (B, C, 1, P, 2))
    _check(rankw, "rankw", torch.float32, (B, C, K))
    _check(acost, "acost", torch.int32, (B, C, 1, 1 << P))
    _check(die_prev, "die_prev", torch.bool, (B, C, K))
    _check(rc, "rc", torch.int32, (B, C))
    dev = _check_device(wdiff, wbase, rankw, acost, die_prev, rc)
    if dev.type == "cpu":
        return forward_t1_plain(K, P, wdiff, wbase, rankw, acost, die_prev, rc)

    S = 1 << K
    pidx = torch.empty((B, C, S), dtype=torch.int32, device=dev)
    dp_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    key_last = torch.empty((B, S), dtype=torch.int32, device=dev)
    scratch = None
    if state_bytes(K):
        scratch = torch.empty((B, 3, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_forward_t1",
            wdiff.data_ptr(),
            wbase.data_ptr(),
            rankw.data_ptr(),
            acost.data_ptr(),
            die_prev.data_ptr(),
            pidx.data_ptr(),
            dp_last.data_ptr(),
            key_last.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B,
            C,
            K,
        )
    forward_t1.launches += 1
    return pidx, dp_last, key_last


forward_t1.launches = 0


def backtrace_t1_plain(opt_idx, pidx):
    """Plain torch version of the T=1 backtrace (see backtrace_t1): the torch
    mirror's walk (wmec._backtrace_from) with no transmission state, then the
    step through column 0."""
    from .wmec import _backtrace_from

    zero = torch.zeros_like(opt_idx)
    path, _trans, _seam = _backtrace_from(opt_idx, zero, zero, pidx[..., None], None)
    rows = torch.arange(pidx.shape[0], device=pidx.device)
    return path, pidx[rows, 0, path[:, 0].long()]


def backtrace_t1(opt_idx, pidx):
    """T=1 backtrace.  opt_idx (B,) i32 is the selected last-column
    bipartition, pidx (B, C, 2^K) i32 the tables from forward_t1.  Walks
    v <- pidx[b, c, v] from the last column to the first, recording v at
    each column before the step.  Returns the index paths (B, C) i32 and the
    state one step through column 0, final (B,) i32, as backtrace_pallas
    does (the segmented solve chains on it)."""
    B, C = pidx.shape[0], pidx.shape[1]
    S = pidx.shape[2] if pidx.dim() == 3 else 0
    if S < 2 or S & (S - 1) or not 1 <= S.bit_length() - 1 <= MAX_K:
        raise ValueError(f"backtrace_t1: pidx must be (B, C, 2^K) with 1 <= K <= {MAX_K}")
    _check(opt_idx, "opt_idx", torch.int32, (B,))
    _check(pidx, "pidx", torch.int32, (B, C, S))
    dev = _check_device(opt_idx, pidx)
    if dev.type == "cpu":
        return backtrace_t1_plain(opt_idx, pidx)

    path = torch.empty((B, C), dtype=torch.int32, device=dev)
    final = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(
            "wmec_backtrace_t1",
            opt_idx.data_ptr(),
            pidx.data_ptr(),
            path.data_ptr(),
            final.data_ptr(),
            B,
            C,
            S.bit_length() - 1,
        )
    backtrace_t1.launches += 1
    return path, final


backtrace_t1.launches = 0


def _select_optimum(K: int, T: int, dp_last, key_last):
    """Batched final-optimum selection with the reference's tie-break: min
    cost, then min Gray key, then min transmission, then min index.
    dp_last (B, T, S) or (B, T*S), key_last (B, S).  Returns (costs, opt_trans,
    opt_idx), each (B,) int32."""
    S = 1 << K
    B = dp_last.shape[0]
    dp = dp_last.reshape(B, T, S)
    key = key_last.reshape(B, S)
    big = 2**30
    m = dp.amin(dim=(1, 2))
    cand = dp == m[:, None, None]
    keyb = torch.where(cand, key[:, None, :], big)
    km = keyb.amin(dim=(1, 2))
    cand = cand & (keyb == km[:, None, None])
    comb = (
        torch.arange(T, dtype=torch.int32, device=dp.device)[:, None] * S
        + torch.arange(S, dtype=torch.int32, device=dp.device)[None, :]
    )
    best = torch.where(cand, comb[None], big).amin(dim=(1, 2))
    return m, best // S, best % S


def solve_batched_cuda(K, T, P, wdiff, wbase, rankw, acost, die_prev, rc):
    """End-to-end batched T=1 solve: forward kernel, optimum selection,
    backtrace kernel.  Returns (costs (B,), index paths (B, C), transmission
    paths (B, C)), int32, matching wmec.solve_batched."""
    if T != 1:
        raise ValueError("solve_batched_cuda solves single individuals (T == 1) only")
    pidx, dp_last, key_last = forward_t1(K, P, wdiff, wbase, rankw, acost, die_prev, rc)
    m, _opt_trans, opt_idx = _select_optimum(K, 1, dp_last, key_last)
    index_path, _final = backtrace_t1(opt_idx.contiguous(), pidx)
    return m, index_path, torch.zeros_like(index_path)
