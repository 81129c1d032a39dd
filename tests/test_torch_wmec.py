"""
Parity of the PyTorch port's wMEC DP (whatshap_torch.ops) with the JAX
reference (whatshap_tpu.ops).  The same numpy inputs go through both, and
every output must be bit-equal: the DP is int32 throughout, so the tolerance
is exact equality.  The reference's Pallas kernels run in interpret mode, as
tests/test_pallas_kernel.py runs them.  The CUDA kernels are held against
these plain versions on the card in tests/test_torch_cuda.py.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whatshap_tpu.core import NumericSampleIds, Pedigree, Read, ReadSet
from whatshap_tpu.ops import wmec as ref_wmec
from whatshap_tpu.ops import wmec_pallas as ref_pallas
from whatshap_tpu.parallel import blocks as ref_blocks
from whatshap_tpu.testhelpers import canonic_index_to_biallelic_gt

from whatshap_torch.ops import wmec, wmec_cuda
from whatshap_torch.parallel import blocks

REPO = Path(__file__).resolve().parent.parent


def _random_packed(rng, n_pos, n_reads, n_ind=1, trios=(), max_q=300):
    """A random instance packed by the reference (as
    tests/test_pallas_kernel.py:_trio_workload builds them)."""
    positions = [(i + 1) * 10 for i in range(n_pos)]
    rs = ReadSet()
    for i in range(n_reads):
        sample = int(rng.randint(0, n_ind))
        start = int(rng.randint(0, n_pos - 1))
        end = int(rng.randint(start + 1, n_pos))
        read = Read(f"R{i}", 50, 0, sample)
        for c in range(start, end + 1):
            if rng.rand() < 0.2 and c not in (start, end):
                continue
            read.add_variant(positions[c], int(rng.randint(0, 2)), int(rng.randint(1, max_q)))
        rs.add(read)
    rs.sort()
    ped = Pedigree(NumericSampleIds())
    for ind in range(n_ind):
        ped.add_individual(
            f"ind{ind}", [canonic_index_to_biallelic_gt(1) for _ in positions], None
        )
    for f, m, c in trios:
        ped.add_relationship(f"ind{f}", f"ind{m}", f"ind{c}")
    rc = [int(rng.randint(1, 10)) for _ in positions]
    return ref_wmec.pack_problem(rs, rc, ped, False, positions)


def _synthetic_packed(n_cols, coverage, seed):
    rs, positions, _ = ref_blocks.make_synthetic_readset(n_cols, coverage, read_len=8, seed=seed)
    ped = Pedigree(NumericSampleIds())
    ped.add_individual(
        "s", [canonic_index_to_biallelic_gt(1) for _ in positions], [None] * len(positions)
    )
    return ref_wmec.pack_problem(rs, [1] * len(positions), ped, False)


def _stack(packed_list, c_pad, k_min=1):
    """Stacked numpy block arrays padded to a common (c_pad, K)."""
    k = max(max(p.K for p in packed_list), k_min)
    return k, ref_blocks.stack_blocks([ref_blocks.pad_block(p, c_pad, k_pad=k) for p in packed_list])


# workloads by name, each made from a numpy seed: (K, arrays, T, P); Pallas needs K >= 7
def _wl_synthetic():
    pl = [_synthetic_packed(32, 6, seed=5 + b) for b in range(2)]
    return (*_stack(pl, 32, k_min=ref_pallas.LANE_BITS), 1, 2)


def _wl_heavy():
    # weights beyond bf16's exact-integer range (256), as in
    # tests/test_backend_parity.py:58
    rng = np.random.RandomState(12)
    pl = [_random_packed(rng, 12, 10, max_q=5000) for _ in range(2)]
    return (*_stack(pl, 16, k_min=ref_pallas.LANE_BITS), 1, 2)


def _wl_trio():
    rng = np.random.RandomState(31)
    pl = [_random_packed(rng, 12, 10, n_ind=3, trios=((0, 1, 2),)) for _ in range(2)]
    return (*_stack(pl, 16), 4, 4)


def _wl_trio_heavy():
    rng = np.random.RandomState(33)
    pl = [_random_packed(rng, 10, 8, n_ind=3, trios=((0, 1, 2),), max_q=5000) for _ in range(2)]
    return (*_stack(pl, 16), 4, 4)


def _wl_quartet():
    rng = np.random.RandomState(41)
    pl = [
        _random_packed(rng, 8, 7, n_ind=4, trios=((0, 1, 2), (0, 1, 3)))
        for _ in range(2)
    ]
    return (*_stack(pl, 8), 16, 4)


WORKLOADS = {
    "t1": _wl_synthetic,
    "t1_heavy": _wl_heavy,
    "trio": _wl_trio,
    "trio_heavy": _wl_trio_heavy,
    "quartet": _wl_quartet,
}


def _load(name):
    K, arrays, T, P = WORKLOADS[name]()
    assert arrays[0].shape[2] == K
    return K, T, P, arrays


def _torch(arrays, device="cpu"):
    return blocks.to_device(arrays, device)


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("name", ["t1", "t1_heavy"])
def test_forward_scan_t1_matches_reference(name):
    """(a) The T=1 forward scan: the wrapper's plain version and the torch
    mirror against the Pallas kernel (interpret) and the XLA scan."""
    K, T, P, arrays = _load(name)
    assert wmec_cuda.kernel_supported(K, T, P)
    ref_p = ref_pallas.forward_scan_pallas(K, T, P, *_jax(arrays), interpret=True)
    pidx, dp_last, key_last = wmec_cuda.forward_t1(K, P, *_torch(arrays))
    dp_m, jmin_m, key_m, pidx_m, pjmin_m = wmec.forward_scan(K, T, P, *_torch(arrays))
    assert pjmin_m is None
    for b in range(arrays[0].shape[0]):
        ref_x = ref_wmec._forward_scan(K, T, P, *_jax([a[b] for a in arrays]))
        for ref in (ref_x, [x[b] for x in ref_p]):
            dp_r, jmin_r, key_r, pidx_r, _pjmin_r = (np.asarray(x) for x in ref)
            assert np.array_equal(dp_last[b].numpy(), dp_r[:, 0])
            assert np.array_equal(key_last[b].numpy(), key_r)
            assert np.array_equal(pidx[b].numpy(), pidx_r[..., 0])
            assert np.array_equal(dp_m[b].numpy(), dp_r)
            assert np.array_equal(jmin_m[b].numpy(), jmin_r)
            assert np.array_equal(key_m[b].numpy(), key_r)
            assert np.array_equal(pidx_m[b].numpy(), pidx_r)


@pytest.mark.parametrize("name", ["t1", "t1_heavy"])
def test_backtrace_t1_matches_reference(name):
    """(b) The T=1 backtrace walk against backtrace_pallas (interpret), from
    the selected optimum and from arbitrary start states."""
    K, T, P, arrays = _load(name)
    pidx, dp_last, key_last = wmec_cuda.forward_t1(K, P, *_torch(arrays))
    B = pidx.shape[0]
    _m, _t, opt = wmec_cuda._select_optimum(K, 1, dp_last, key_last)
    starts = [opt, torch.from_numpy(np.random.RandomState(3).randint(0, 1 << K, B).astype(np.int32))]
    for start in starts:
        path, final = wmec_cuda.backtrace_t1(start, pidx)
        path_r, final_r = ref_pallas.backtrace_pallas(
            K, jnp.asarray(start.numpy()), jnp.asarray(pidx.numpy()).reshape(B, -1, (1 << K) >> 7, 128),
            interpret=True,
        )
        assert np.array_equal(path.numpy(), np.asarray(path_r))
        assert np.array_equal(final.numpy(), np.asarray(final_r))


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_solve_batched_matches_reference(name):
    """(c) The torch mirror's batched solve against wmec.solve_batched at
    T = 1, 4 and 16, with weights above 256; T=1 also through the kernel
    route's wrappers (plain versions on the CPU)."""
    K, T, P, arrays = _load(name)
    ref = [np.asarray(x) for x in ref_wmec.solve_batched(K, T, P, *_jax(arrays))]
    routes = [wmec.solve_batched]
    if wmec_cuda.kernel_supported(K, T, P):
        routes.append(wmec_cuda.solve_batched_cuda)
    for solve in routes:
        out = solve(K, T, P, *_torch(arrays))
        for x, r in zip(out, ref):
            assert x.dtype == torch.int32
            assert np.array_equal(x.numpy(), r), solve.__name__


def test_solve_batched_pallas_t1_matches_port():
    """The end-to-end T=1 kernel route (plain on the CPU) against the
    reference's solve_batched_pallas in interpret mode."""
    K, T, P, arrays = _load("t1")
    ref = ref_pallas.solve_batched_pallas(K, T, P, *_jax(arrays), interpret=True)
    out = wmec_cuda.solve_batched_cuda(K, T, P, *_torch(arrays))
    for x, r in zip(out, ref):
        assert np.array_equal(x.numpy(), np.asarray(r))


def test_fold_dying_matches_reference():
    """The batched fold (used by the scan, and by the seam fold of the
    pedigree slice to come) against the reference's single-block fold."""
    import jax

    rng = np.random.RandomState(8)
    K, T, B = 5, 4, 3
    S = 1 << K
    cost = rng.randint(0, 6, size=(B, S, T)).astype(np.int32)
    key = rng.randint(0, 4, size=(B, S)).astype(np.int32)
    jmin = rng.randint(0, T, size=(B, S, T)).astype(np.int32)
    die = rng.rand(B, K) < 0.5
    out = wmec._fold_dying(
        K, T, torch.from_numpy(die), torch.from_numpy(cost), torch.from_numpy(key),
        torch.from_numpy(jmin),
    )
    for b in range(B):
        ref = jax.jit(ref_wmec._fold_dying, static_argnums=(0, 1))(
            K, T, jnp.asarray(die[b]), jnp.asarray(cost[b]), jnp.asarray(key[b]), jnp.asarray(jmin[b])
        )
        for x, r in zip(out, ref):
            assert np.array_equal(x[b].numpy(), np.asarray(r))


def test_to_device_round_trip():
    K, T, P, arrays = _load("trio")
    moved = blocks.to_device(arrays, "cpu")
    for a, t in zip(arrays, moved):
        assert t.dtype == blocks._TORCH_DTYPES[a.dtype]
        assert tuple(t.shape) == a.shape and t.is_contiguous()
        assert np.array_equal(t.numpy(), a)


def test_wrappers_check_inputs():
    K, T, P, arrays = _load("t1")
    ta = list(_torch(arrays))
    with pytest.raises(ValueError):
        wmec_cuda.forward_t1(K, P, ta[0].double(), *ta[1:])
    with pytest.raises(ValueError):
        wmec_cuda.forward_t1(K + 1, P, *ta)
    with pytest.raises(ValueError):
        wmec_cuda.forward_t1(K, P, ta[0].transpose(2, 3).contiguous().transpose(2, 3), *ta[1:])
    with pytest.raises(ValueError):
        wmec_cuda.forward_t1(wmec_cuda.MAX_K + 1, P, *ta)
    pidx, _dp, _key = wmec_cuda.forward_t1(K, P, *ta)
    with pytest.raises(ValueError):
        wmec_cuda.backtrace_t1(torch.zeros(pidx.shape[0], dtype=torch.int64), pidx)
    with pytest.raises(ValueError):
        wmec_cuda.backtrace_t1(torch.zeros(pidx.shape[0], dtype=torch.int32), pidx[..., :-1])
    with pytest.raises(ValueError):
        wmec_cuda.solve_batched_cuda(K, 4, P, *ta)


def test_wrappers_count_kernel_launches_only():
    """On CPU tensors the wrappers run their plain versions: no launch."""
    K, T, P, arrays = _load("t1")
    before = (wmec_cuda.forward_t1.launches, wmec_cuda.backtrace_t1.launches)
    wmec_cuda.solve_batched_cuda(K, T, P, *_torch(arrays))
    assert (wmec_cuda.forward_t1.launches, wmec_cuda.backtrace_t1.launches) == before


def test_kernel_envelope():
    assert all(wmec_cuda.kernel_supported(k, 1, 2) for k in range(1, 17))
    assert not wmec_cuda.kernel_supported(0, 1, 2)
    assert not wmec_cuda.kernel_supported(wmec_cuda.MAX_K + 1, 1, 2)
    assert not wmec_cuda.kernel_supported(10, 4, 4)
    assert not wmec_cuda.kernel_supported(10, 1, 4)
    # the forward state leaves shared memory above K = 14 (12 B per state)
    assert wmec_cuda.state_bytes(14) == 0
    assert wmec_cuda.state_bytes(15) == 12 << 15


def test_launch_chunking_is_exact(monkeypatch):
    """A table budget below the batch splits the launch into sequential
    chunks with identical results; below one block it raises."""
    K, T, P, arrays = _load("t1_heavy")
    ta = _torch(arrays)
    whole = wmec.solve_batched_auto(K, T, P, *ta)
    per_block = arrays[0].shape[1] * (1 << K) * 4
    monkeypatch.setattr(wmec, "_table_budget", lambda device: per_block)
    chunked = wmec.solve_batched_auto(K, T, P, *ta)
    for x, y in zip(whole, chunked):
        assert torch.equal(x, y)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: per_block - 1)
    with pytest.raises(NotImplementedError, match="segmented"):
        wmec.solve_batched_auto(K, T, P, *ta)


def _port_files():
    return sorted((REPO / "whatshap_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_reference():
    """(f) No module of the port, and not chip_smoke.py, imports jax or the
    reference package (AST scan of every import statement)."""
    banned = ("jax", "jaxlib", "whatshap_tpu", "tools")
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, f"{path}: imports {n}"


def test_port_imports_with_jax_blocked():
    """`import whatshap_torch` and every module of it work in a process
    where jax and the reference package cannot be imported."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in (REPO / "whatshap_torch").rglob("*.py")
    )
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'whatshap_tpu'): sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
