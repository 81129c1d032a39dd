"""
Block batching: pad independent phase blocks to a common (columns, coverage)
bucket, stack them, and move the stacks to the GPU for one batched launch.

The reference processes one connected phase block at a time on one CPU core;
this package batches thousands of blocks per launch (one CTA per block in the
CUDA kernels of whatshap_torch.ops.wmec_cuda).

Padding preserves exact DP semantics: padded trailing columns have zero
weights, all-compatible zero-cost assignments, prohibitive recombination
cost (so the transmission vector is carried through unchanged) and copy the
last real column's rank weights (so the final tie-break key is preserved).
"""

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.wmec import INF, PackedProblem


@dataclass
class PaddedArrays:
    """Device-ready arrays for one block, padded to C_pad columns."""

    wdiff: np.ndarray  # (C_pad, K, T*P*2) float32
    wbase: np.ndarray  # (C_pad, T, P, 2) int32
    rankw: np.ndarray  # (C_pad, K) float32
    acost: np.ndarray  # (C_pad, T, 2^P) int32
    die_prev: np.ndarray  # (C_pad, K) bool
    rc: np.ndarray  # (C_pad,) int32
    n_cols: int  # real column count


def pad_block(packed: PackedProblem, c_pad: int, k_pad: int = None) -> PaddedArrays:
    C, K, T, P = packed.n_cols, packed.K, packed.T, packed.P
    assert c_pad >= C
    if k_pad is None:
        k_pad = K
    assert k_pad >= K

    rankw = np.where(
        packed.rank >= 0, (1 << np.maximum(packed.rank, 0).astype(np.int64)), 0
    ).astype(np.float32)
    wdiff = packed.wdiff.reshape(C, K, T * P * 2).astype(np.float32)

    def pad_k(a, fill=0):
        if k_pad == K:
            return a
        pad_width = [(0, 0)] * a.ndim
        pad_width[1] = (0, k_pad - K)
        return np.pad(a, pad_width, constant_values=fill)

    wdiff = pad_k(wdiff)
    rankw_p = pad_k(rankw)
    die_prev = pad_k(packed.die_prev)

    nA = 1 << P
    out = PaddedArrays(
        wdiff=np.zeros((c_pad, k_pad, T * P * 2), dtype=np.float32),
        wbase=np.zeros((c_pad, T, P, 2), dtype=np.int32),
        rankw=np.zeros((c_pad, k_pad), dtype=np.float32),
        acost=np.zeros((c_pad, T, nA), dtype=np.int32),
        die_prev=np.zeros((c_pad, k_pad), dtype=bool),
        rc=np.full(c_pad, INF, dtype=np.int32),
        n_cols=C,
    )
    out.wdiff[:C] = wdiff
    out.wbase[:C] = packed.wbase
    out.rankw[:C] = rankw_p
    out.acost[:C] = packed.acost
    out.die_prev[:C] = die_prev
    out.rc[:C] = packed.rc
    if C > 0 and c_pad > C:
        # keep the final tie-break key alive through the padded tail
        out.rankw[C:] = rankw_p[C - 1]
        # fold reads dying after the last real column at the first pad column
        # (harmless: identical to what an extra real column would do)
        # die flags beyond the last real column default to False.
    return out


def stack_blocks(blocks: Sequence[PaddedArrays]) -> Tuple[np.ndarray, ...]:
    """Stack equal-shape padded blocks along a leading batch axis."""
    return (
        np.stack([b.wdiff for b in blocks]),
        np.stack([b.wbase for b in blocks]),
        np.stack([b.rankw for b in blocks]),
        np.stack([b.acost for b in blocks]),
        np.stack([b.die_prev for b in blocks]),
        np.stack([b.rc for b in blocks]),
    )


_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def to_device(stacked: Sequence[np.ndarray], device) -> Tuple[torch.Tensor, ...]:
    """Move stacked block arrays (the stack_blocks tuple: wdiff, wbase, rankw,
    acost, die_prev, rc) to `device` as tensors of the same dtypes and shapes.

    The arrays travel in ONE host-to-device copy: they are packed into a
    single byte buffer, each part at a 16-byte aligned offset, and viewed
    back as typed tensors on the device (the views share that buffer)."""
    arrays = [np.ascontiguousarray(a) for a in stacked]
    offsets = []
    total = 0
    for a in arrays:
        offsets.append(total)
        total += (a.nbytes + 15) // 16 * 16
    buf = np.empty(total, dtype=np.uint8)
    for a, off in zip(arrays, offsets):
        buf[off : off + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(buf).to(device)
    return tuple(
        dev[off : off + a.nbytes].view(_TORCH_DTYPES[a.dtype]).reshape(a.shape)
        for a, off in zip(arrays, offsets)
    )


def make_synthetic_readset(
    n_cols: int,
    coverage: int,
    read_len: int = 10,
    error_rate: float = 0.05,
    seed: int = 0,
):
    """Generate a random diploid phasing instance: reads tile the columns at
    the given coverage, alleles follow two random haplotypes with errors.

    Returns (ReadSet, positions, true_haplotype).  Used by benchmarks and the
    compile-check entry point.
    """
    from ..core.readset import Read, ReadSet

    rng = np.random.RandomState(seed)
    hap = rng.randint(0, 2, size=n_cols)
    positions = (np.arange(n_cols) + 1) * 10

    rs = ReadSet()
    idx = 0
    for lane in range(coverage):
        start = int(rng.randint(0, max(read_len // 2, 1)))
        while start < n_cols - 1:
            length = int(
                np.clip(rng.poisson(read_len), 2, n_cols - start)
            )
            side = int(rng.randint(0, 2))
            read = Read(f"sim_{idx}", 50, 0, 0)
            idx += 1
            for c in range(start, start + length):
                allele = hap[c] if side == 0 else 1 - hap[c]
                if rng.rand() < error_rate:
                    allele = 1 - allele
                read.add_variant(int(positions[c]), int(allele), int(rng.randint(10, 40)))
            rs.add(read)
            start += length
    rs.sort()
    return rs, [int(p) for p in positions], hap
