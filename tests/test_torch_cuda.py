"""
The port's CUDA kernels and its CUDA route, on the card.  Every test here
needs a CUDA device and skips where there is none.  The file imports
nothing of jax or of the reference package, so that it also runs where only
the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The kernels are held bit-equal against their plain torch versions (which
tests/test_torch_wmec.py holds against the JAX reference on the CPU).
"""

import numpy as np
import pytest
import torch

import whatshap_torch.core as core
from whatshap_torch.ops import wmec, wmec_cuda
from whatshap_torch.parallel import blocks


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _pedigree(n_cols, n_ind=1, trios=()):
    ped = core.Pedigree(core.NumericSampleIds())
    for i in range(n_ind):
        ped.add_individual(f"ind{i}", [core.Genotype([0, 1])] * n_cols, None)
    for f, m, c in trios:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    return ped


def _bucket(K, n_blocks=3, n_cols=64, seed=0):
    padded = []
    for b in range(n_blocks):
        rs, positions, _ = blocks.make_synthetic_readset(n_cols, K, read_len=6, seed=seed + b)
        p = wmec.pack_problem(rs, [1] * len(positions), _pedigree(len(positions)), False)
        padded.append(blocks.pad_block(p, n_cols, k_pad=max(K, p.K)))
    arrays = list(blocks.stack_blocks(padded))
    arrays[0][-1] *= 41  # one block with weights above 256
    arrays[1][-1] *= 41
    return arrays


def _chromosome(n_blocks, n_cols, coverage, seed):
    rs = core.ReadSet()
    for b in range(n_blocks):
        sub, _pos, _hap = blocks.make_synthetic_readset(n_cols, coverage, read_len=6, seed=seed + b)
        for read in sub:
            r = core.Read(f"b{b}_{read.name}", 50, 0, 0)
            for v in read:
                r.add_variant(v.position + b * 10 * (n_cols + 10), v.allele, v.quality)
            rs.add(r)
    rs.sort()
    return rs, rs.get_positions()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3, 5, 7, 10, 14, 15, 16])
def test_kernels_match_plain(cuda_device, K):
    arrays = blocks.to_device(_bucket(K, seed=10 * K), cuda_device)
    kern = wmec_cuda.forward_t1(K, 2, *arrays)
    plain = wmec_cuda.forward_t1_plain(K, 2, *arrays)
    torch.cuda.synchronize()
    for x, y in zip(kern, plain):
        assert torch.equal(x, y)
    _m, _t, opt = wmec_cuda._select_optimum(K, 1, kern[1], kern[2])
    path, final = wmec_cuda.backtrace_t1(opt.contiguous(), kern[0])
    path_p, final_p = wmec_cuda.backtrace_t1_plain(opt, kern[0])
    torch.cuda.synchronize()
    assert torch.equal(path, path_p) and torch.equal(final, final_p)


@pytest.mark.cuda
def test_route_on_cuda_matches_cpu(cuda_device):
    """PedigreeDPTable on the card, through both kernels, equals the CPU
    (plain torch) run: batched route and single-block route."""
    for n_blocks in (4, 1):
        rs, positions = _chromosome(n_blocks, 48, 8, seed=n_blocks)
        ped = _pedigree(len(positions))
        fwd, bt = wmec_cuda.forward_t1.launches, wmec_cuda.backtrace_t1.launches
        gpu = core.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions)
        assert gpu.device.type == "cuda"
        assert wmec_cuda.forward_t1.launches > fwd and wmec_cuda.backtrace_t1.launches > bt
        cpu = core.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions, device="cpu")
        assert gpu.get_optimal_cost() == cpu.get_optimal_cost()
        assert gpu.get_optimal_partitioning() == cpu.get_optimal_partitioning()
        assert np.array_equal(gpu._result.index_path, cpu._result.index_path)


@pytest.mark.cuda
def test_route_on_cuda_refuses_what_it_cannot_solve(cuda_device):
    """A pedigree, or K above the kernels' envelope, raises on CUDA instead
    of leaving the card."""
    rs, positions = _chromosome(1, 12, 3, seed=1)
    ped = _pedigree(len(positions), n_ind=3, trios=((0, 1, 2),))
    with pytest.raises(NotImplementedError, match="pedigree"):
        core.PedigreeDPTable(rs, [1] * len(positions), ped, False, positions)
    k = wmec_cuda.MAX_K + 1
    rs, positions = _chromosome(1, 40, k, seed=2)
    with pytest.raises(NotImplementedError, match="segmented"):
        core.PedigreeDPTable(rs, [1] * len(positions), _pedigree(len(positions)), False, positions)
