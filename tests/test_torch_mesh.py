"""
Parity of the port's batched launches over several devices with the JAX
reference on the CPU: wmec.forward_cost_batched (the costs-only forward
from the initial state) against the reference's, the sharded solves of
parallel/mesh.py against the reference's over its mesh of 8 virtual CPU
devices (tests/conftest.py) and against per-block serial solves, the route's
sharded launches (wmec.MESH_DEVICES, LAUNCH_STATS), the phase CLI with every
batched launch sharded, and the dry run of parallel/dryrun.py.  The port's
"devices" here are the CPU repeated n times: the shards run one after
another through the same split, copies and gather as on n cards.  Every
output must be bit-equal (int32 DP: the tolerance is exact equality); the
VCFs byte-identical.  tests/test_mesh_sharding.py and tests/test_cli_mesh.py
run here on the port as the tests named after them.
"""

import numpy as np
import pytest
import torch

import jax

from whatshap_tpu.cli.phase import run_whatshap as ref_run_whatshap
from whatshap_tpu.ops import wmec as ref_wmec
from whatshap_tpu.parallel import mesh as ref_mesh
from whatshap_tpu.parallel import workloads as ref_workloads

from whatshap_torch.cli.phase import run_whatshap
from whatshap_torch.ops import wmec, wmec_cuda
from whatshap_torch.parallel import blocks, dryrun, workloads
from whatshap_torch.parallel import mesh as mesh_mod

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread_no_mesh():
    """One torch thread (the mirror's column loop is many small ops, faster
    on one thread than on threads the test workers share), and the route's
    mesh and launch records as a fresh process has them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = wmec.MESH_DEVICES
    wmec.MESH_DEVICES = None
    wmec.LAUNCH_STATS.clear()
    yield
    wmec.MESH_DEVICES = saved
    wmec.LAUNCH_STATS.clear()
    torch.set_num_threads(n)


def _cpus(n):
    return mesh_mod.make_block_mesh([CPU] * n)


def _ref_mesh(n):
    return ref_mesh.make_block_mesh(jax.devices()[:n])


def _same_batches(ref, port):
    """The port's builders give the reference's stacked arrays."""
    assert ref[:3] == port[:3]
    for a, b in zip(ref[4], port[4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _build(kind, n_blocks, seed, pkg):
    if kind == "single":
        return pkg.build_single_sample_batch(n_blocks, n_cols=16, coverage=4, seed=seed)
    return pkg.build_trio_batch(n_blocks, n_pos=10, seed=seed)


# ---------------------------------------------------------------------------
# forward_cost_batched
# ---------------------------------------------------------------------------


def _cost_batch(T, seed):
    """A batch of random instances at T = 1 (8 blocks of 32 columns), T = 4
    (6 trio blocks of 12 positions) or T = 16 (3 blocks of two trios with
    shared parents, 8 positions), K <= 15."""
    if T == 1:
        return ref_workloads.build_single_sample_batch(8, n_cols=32, coverage=5, seed=seed)
    if T == 4:
        return ref_workloads.build_trio_batch(6, n_pos=12, n_reads=10, seed=seed)
    return ref_workloads.build_trio_batch(3, n_pos=8, n_reads=8, seed=seed, n_ind=4,
                                          trios=((0, 1, 2), (0, 1, 3)), c_pad=8)


@pytest.mark.parametrize("T,seed", [(1, s) for s in (0, 3, 11, 17, 29)] + [(4, s) for s in (7, 23, 31, 41, 47)]
                         + [(16, s) for s in (5, 13, 19)])
def test_forward_cost_batched_matches_reference(T, seed):
    """All three outputs of forward_cost_batched equal the reference's,
    transposed: dp_last and jmin_last (B, T, 2^K) against (B, 2^K, T),
    key_last (B, 2^K)."""
    K, T_, P, _packed, arrays = _cost_batch(T, seed)
    assert T_ == T and K <= 15
    arrays = [np.asarray(a) for a in arrays]
    ref = [np.asarray(x) for x in ref_wmec.forward_cost_batched(K, T, P, *arrays)]
    got = wmec.forward_cost_batched(K, T, P, *blocks.to_device(arrays, CPU))
    np.testing.assert_array_equal(got[0].numpy(), ref[0].transpose(0, 2, 1))
    np.testing.assert_array_equal(got[1].numpy(), ref[1].transpose(0, 2, 1))
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    assert [x.dtype for x in got] == [torch.int32] * 3


def test_forward_cost_batched_routes(monkeypatch):
    """Shapes the kernels take run their carry pass (the wrappers' plain
    versions on CPU tensors) from a zero carry, chunked under the table
    budget counting the state and the carry in and out; other shapes on the
    CPU run the mirror's forward_carry, and on CUDA raise."""
    K, T, P, _packed, arrays = ref_workloads.build_trio_batch(4, n_pos=10, seed=7)
    arrays = blocks.to_device([np.asarray(a) for a in arrays], CPU)
    seen = []
    real = wmec._launch_batched
    monkeypatch.setattr(wmec, "_launch_batched", lambda *a: seen.append(a[-1]) or real(*a))
    whole = wmec.forward_cost_batched(K, T, P, *arrays)
    assert seen == [((3 * T + 2) * 4 << K) + wmec_cuda.state_bytes(K, T, P)]
    monkeypatch.setattr(wmec, "_table_budget", lambda device: seen[0] + 1)
    chunked = wmec.forward_cost_batched(K, T, P, *arrays)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    monkeypatch.setattr(wmec_cuda, "kernel_supported", lambda *a: False)
    mirror = wmec.forward_cost_batched(K, T, P, *arrays)
    for a, b in zip(whole, mirror):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="item 5"):
        wmec._pick(K, T, P, torch.device("cuda"), wmec_cuda._carry_pass, wmec.forward_carry)


def test_optimal_costs_from_batched_equal_solve_costs():
    """The minimum of forward_cost_batched's final costs is each block's
    optimal cost, as the full solve finds it."""
    K, T, P, _packed, arrays = workloads.build_trio_batch(5, n_pos=12, seed=23)
    dp_last, _j, _k = mesh_mod.run_blocks_sharded(_cpus(2), K, T, P, arrays)
    costs, _ip, _tp = mesh_mod.solve_blocks_sharded(_cpus(2), K, T, P, arrays)
    np.testing.assert_array_equal(mesh_mod.optimal_costs_from_batched(dp_last), costs)
    np.testing.assert_array_equal(mesh_mod.optimal_costs_from_batched(dp_last.numpy()), costs)


# ---------------------------------------------------------------------------
# solve_blocks_sharded over n devices
# ---------------------------------------------------------------------------

SHARD_CASES = (
    [(n, "single", 2 * n) for n in (1, 2, 3, 8)]
    + [(n, "trio", n) for n in (1, 2, 3, 8)]
    + [(n, "single", 2 * n + 1) for n in (2, 3, 8)]  # uneven shards
    + [(n, "trio", n + 1) for n in (2, 3, 8)]
)


@pytest.mark.parametrize("n,kind,n_blocks", SHARD_CASES)
def test_solve_blocks_sharded_matches_reference_and_serial(n, kind, n_blocks):
    """The sharded full solve over cpu x n equals the reference's sharded
    solve over n of its devices (or over one where B is no multiple of n:
    its shard_map needs one) on costs, index paths and transmission paths,
    and per-block serial solves on costs, partitionings and transmission
    paths."""
    seed = 100 + 7 * n + n_blocks
    ref = _build(kind, n_blocks, seed, ref_workloads)
    port = _build(kind, n_blocks, seed, workloads)
    _same_batches(ref, port)
    K, T, P, packed_list, arrays = port
    got = mesh_mod.solve_blocks_sharded(_cpus(n), K, T, P, arrays)
    assert wmec.LAUNCH_STATS[-1] == (K, T, arrays[0].shape[1], n_blocks, n_blocks, min(n, n_blocks))
    ref_n = n if n_blocks % n == 0 else 1
    want = ref_mesh.solve_blocks_sharded(_ref_mesh(ref_n), K, T, P, [np.asarray(a) for a in ref[4]])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    workloads.assert_batched_matches_serial(packed_list, *got)
    ref_workloads.assert_batched_matches_serial(ref[3], *got)


# ---------------------------------------------------------------------------
# the route's sharded launches
# ---------------------------------------------------------------------------


def _route_call(route, K, T, P, arrays, seed):
    B = arrays[0].shape[0]
    rng = np.random.RandomState(seed)
    if route == "forward_m_auto":
        seeds = rng.randint(0, 50, (B, 2, T)).astype(np.int32)
        return wmec.forward_m_auto(K, T, P, *arrays, torch.from_numpy(seeds))
    if route == "solve_seeded_auto":
        dp0 = torch.from_numpy(rng.randint(0, 50, (B, T)).astype(np.int32))
        die_next = torch.from_numpy(rng.rand(B, K) < 0.5)
        return wmec.solve_seeded_auto(K, T, P, *arrays, dp0, die_next)
    return getattr(wmec, route)(K, T, P, *arrays)


def _as_tuple(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


@pytest.mark.parametrize("route", ["solve_batched_auto", "forward_m_auto", "solve_seeded_auto",
                                   "forward_cost_batched"])
def test_route_launches_shard_over_mesh_devices(route):
    """Every batched launch of the route (the full solve, both passes of the
    pedigree route, the costs-only forward) splits B = 5 trio blocks over
    wmec.MESH_DEVICES = cpu x 3 (shards of 2, 2 and 1), records it in
    LAUNCH_STATS with n_dev = 3, and returns the unsharded launch's
    outputs; a mesh of more devices than blocks uses one a block."""
    K, T, P, _packed, arrays = workloads.build_trio_batch(5, n_pos=10, seed=19)
    arrays = blocks.to_device(arrays, CPU)
    whole = _as_tuple(_route_call(route, K, T, P, arrays, seed=3))
    assert wmec.LAUNCH_STATS[-1][-1] == 1
    for devices, n_dev in (([CPU] * 3, 3), ([CPU] * 8, 5)):
        wmec.MESH_DEVICES = devices
        sharded = _as_tuple(_route_call(route, K, T, P, arrays, seed=3))
        assert wmec.LAUNCH_STATS[-1] == (K, T, arrays[0].shape[1], 5, 5, n_dev)
        assert len(sharded) == len(whole)
        for a, b in zip(whole, sharded):
            assert torch.equal(a, b)


def test_shards_are_contiguous_and_launched_in_block_order(monkeypatch):
    """The shards are contiguous runs of blocks (2, 2, 2 and 1 of 7 over four
    devices, each on its device), launched one after another before their
    outputs are put together in block order (the counterpart of the
    reference's test_input_arrays_actually_sharded)."""
    K, T, P, _packed, arrays = workloads.build_single_sample_batch(7, n_cols=16, coverage=4, seed=5)
    arrays = blocks.to_device(arrays, CPU)
    calls = []

    def solve(K_, T_, P_, *arrs):
        calls.append((arrs[0].device, arrs[5].clone()))
        return arrs[5].clone(), arrs[4].clone()

    wmec.MESH_DEVICES = [CPU] * 4
    out = wmec._launch_batched(solve, K, T, P, arrays, 0)
    assert [c[1].shape[0] for c in calls] == [2, 2, 2, 1]
    assert all(c[0] == CPU for c in calls)
    assert torch.equal(torch.cat([c[1] for c in calls]), arrays[5])
    assert torch.equal(out[0], arrays[5]) and torch.equal(out[1], arrays[4])
    assert wmec.LAUNCH_STATS == [(K, T, 16, 7, 7, 4)]


def test_each_shard_is_chunked_under_its_device_budget(monkeypatch):
    """Each shard is chunked against its own device's table budget: with a
    budget of two blocks, shards of 3 and 2 blocks launch as 2 + 1 and 2,
    and the result is the unsharded, unchunked launch's."""
    K, T, P, _packed, arrays = workloads.build_single_sample_batch(5, n_cols=16, coverage=4, seed=9)
    arrays = blocks.to_device(arrays, CPU)
    whole = wmec.solve_batched_auto(K, T, P, *arrays)
    sizes = []
    real = wmec_cuda.solve_batched_cuda
    monkeypatch.setattr(wmec_cuda, "solve_batched_cuda", lambda *a: sizes.append(a[3].shape[0]) or real(*a))
    per_block = (16 * 4 << K) + wmec_cuda.state_bytes(K, T, P)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: 2 * per_block + 1)
    wmec.MESH_DEVICES = [CPU] * 2
    sharded = wmec.solve_batched_auto(K, T, P, *arrays)
    assert sizes == [2, 1, 2]
    for a, b in zip(whole, sharded):
        assert torch.equal(a, b)


def test_forward_m_seed_split_shards_each_launch(monkeypatch):
    """Pass 1's seed split (a budget below a block's seeds' cost planes)
    still shards each of its launches over the mesh, and m equals the
    unsplit, unsharded launch's (three children, T = 64: past the cluster
    kernel, where a seed's planes count)."""
    K, T, P, _packed, arrays = workloads.build_trio_batch(
        4, n_pos=6, n_reads=6, seed=29, n_ind=5, trios=((0, 1, 2), (0, 1, 3), (0, 1, 4)), c_pad=8
    )
    assert T == 64 and not wmec_cuda.cluster_supported(K, T, P)
    arrays = blocks.to_device(arrays, CPU)
    seeds = torch.from_numpy(np.random.RandomState(4).randint(0, 40, (4, 3, T)).astype(np.int32))
    whole = wmec.forward_m_auto(K, T, P, *arrays, seeds)
    per_seed = wmec_cuda.state_bytes(K, T, P, seeds=1)
    monkeypatch.setattr(wmec, "_table_budget", lambda device: 2 * per_seed)
    wmec.MESH_DEVICES = [CPU] * 2
    wmec.LAUNCH_STATS.clear()
    split = wmec.forward_m_auto(K, T, P, *arrays, seeds)
    assert torch.equal(split, whole)
    assert [s[-1] for s in wmec.LAUNCH_STATS] == [2, 2]


def test_mesh_devices_default():
    """MESH_DEVICES None: a CPU launch stays on its device; make_block_mesh
    names the devices it is given, and by default every card (raising where
    there is none, as every entry point of the port)."""
    assert wmec._mesh_devices(CPU) == [CPU]
    wmec.MESH_DEVICES = ["cpu", CPU]
    assert wmec._mesh_devices(CPU) == [CPU, CPU]
    assert mesh_mod.make_block_mesh(["cpu", "cpu"]) == [CPU, CPU]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh_mod.make_block_mesh()


# ---------------------------------------------------------------------------
# tests/test_mesh_sharding.py on the port
# ---------------------------------------------------------------------------


def test_single_sample_sharded_parity():
    n = 8
    K, T, P, packed_list, arrays = workloads.build_single_sample_batch(2 * n, n_cols=32, coverage=5, seed=11)
    costs, index_paths, trans_paths = mesh_mod.solve_blocks_sharded(_cpus(n), K, T, P, arrays)
    assert costs.shape == (2 * n,)
    workloads.assert_batched_matches_serial(packed_list, costs, index_paths, trans_paths)


def test_trio_sharded_parity():
    n = 8
    K, T, P, packed_list, arrays = workloads.build_trio_batch(n, n_pos=12, seed=23)
    assert T == 4
    costs, index_paths, trans_paths = mesh_mod.solve_blocks_sharded(
        _cpus(n), K, T, P, [np.asarray(a) for a in arrays]
    )
    workloads.assert_batched_matches_serial(packed_list, costs, index_paths, trans_paths)


def test_sharded_matches_unsharded_device_solve():
    """Sharding must not change results against the same batched solve on
    one device, nor against the reference's unsharded solve."""
    n = 8
    K, T, P, _packed, arrays = workloads.build_single_sample_batch(2 * n, n_cols=16, coverage=4, seed=3)
    sharded = mesh_mod.solve_blocks_sharded(_cpus(n), K, T, P, arrays)
    plain = wmec.solve_batched(K, T, P, *blocks.to_device(arrays, CPU))
    ref = ref_wmec.solve_batched(K, T, P, *[np.asarray(a) for a in arrays])
    for s, p, r in zip(sharded, plain, ref):
        np.testing.assert_array_equal(s, p.numpy())
        np.testing.assert_array_equal(s, np.asarray(r))


def test_input_arrays_actually_sharded(monkeypatch):
    """Each of the n devices gets a shard of B / n blocks (no replicated
    layout)."""
    n = 8
    K, T, P, _packed, arrays = workloads.build_single_sample_batch(n, n_cols=16, coverage=4, seed=5)
    shards = []
    real = wmec._launch_chunked
    monkeypatch.setattr(wmec, "_launch_chunked", lambda *a: shards.append(a[4][0]) or real(*a))
    mesh_mod.solve_blocks_sharded(_cpus(n), K, T, P, arrays)
    assert len(shards) == n
    assert {s.shape[0] for s in shards} == {arrays[0].shape[0] // n}
    assert torch.equal(torch.cat(shards), torch.from_numpy(arrays[0]))


# ---------------------------------------------------------------------------
# tests/test_cli_mesh.py on the port (files by chip_smoke.write_synth)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth_chrom(tmp_path_factory):
    from chip_smoke import write_synth

    return write_synth(tmp_path_factory.mktemp("synth"), 400, 6, seed=5, vars_per_read=8, spacing=60,
                       break_every=40)


@pytest.fixture(scope="module")
def synth_trio(tmp_path_factory):
    from chip_smoke import write_synth

    return write_synth(tmp_path_factory.mktemp("synth_trio"), 160, 4, seed=9, trio=True, vars_per_read=8,
                       spacing=60, break_every=30)


def _phase(data, out_path, fn=run_whatshap, trio=False, **kwargs):
    args = dict(phase_input_files=[data["bam"]], variant_file=data["vcf"], output=str(out_path),
                write_command_line_header=False)
    if trio:
        args.update(reference=data["fasta"], ped=data["ped"])
    else:
        args.update(reference=False)
    fn(**args, **kwargs)
    return out_path.read_bytes()


def test_phase_cli_mesh_byte_identical(synth_chrom, tmp_path, monkeypatch):
    """The phase CLI with every batched launch over cpu x 8 writes the bytes
    of the run on the CPU alone, and of the reference's run; a launch spanned
    more than one device."""
    monkeypatch.delenv("WHATSHAP_TPU_BACKEND", raising=False)
    wmec.MESH_DEVICES = [CPU]
    single = _phase(synth_chrom, tmp_path / "single.vcf", device="cpu")
    assert all(s[-1] == 1 for s in wmec.LAUNCH_STATS)
    wmec.MESH_DEVICES = [CPU] * 8
    wmec.LAUNCH_STATS.clear()
    sharded = _phase(synth_chrom, tmp_path / "sharded.vcf", device="cpu")
    assert any(n_dev > 1 for (_k, _t, _c, _b, _bp, n_dev) in wmec.LAUNCH_STATS), "no sharded launch"
    assert sharded == single
    assert sharded == _phase(synth_chrom, tmp_path / "ref.vcf", fn=ref_run_whatshap)


def test_phase_trio_cli_batched_mesh_byte_identical(synth_trio, tmp_path, monkeypatch):
    """A trio chromosome (T = 4) takes the pedigree route with its launches
    over cpu x 8, byte-identical to the reference's exact host solve at CLI
    granularity."""
    monkeypatch.setenv("WHATSHAP_TPU_BACKEND", "numpy")
    host = _phase(synth_trio, tmp_path / "host.vcf", fn=ref_run_whatshap, trio=True)
    wmec.MESH_DEVICES = [CPU] * 8
    sharded = _phase(synth_trio, tmp_path / "sharded.vcf", trio=True, device="cpu")
    assert any(t > 1 and n_dev > 1 for (_k, t, _c, _b, _bp, n_dev) in wmec.LAUNCH_STATS), (
        "trio CLI run never launched a sharded pedigree batch"
    )
    assert sharded == host
    assert host.count(b"|") > 60


def test_phase_cli_mesh_matches_default_route(synth_chrom, tmp_path, monkeypatch):
    """The sharded route agrees with the port's default (MESH_DEVICES None:
    the CPU alone) and with the reference's default route."""
    monkeypatch.delenv("WHATSHAP_TPU_BACKEND", raising=False)
    auto = _phase(synth_chrom, tmp_path / "auto.vcf", device="cpu")
    assert all(s[-1] == 1 for s in wmec.LAUNCH_STATS)
    wmec.MESH_DEVICES = [CPU] * 3
    sharded = _phase(synth_chrom, tmp_path / "sharded.vcf", device="cpu")
    assert sharded == auto
    assert auto == _phase(synth_chrom, tmp_path / "ref.vcf", fn=ref_run_whatshap)


# ---------------------------------------------------------------------------
# initialize_distributed, entry(), the dry run
# ---------------------------------------------------------------------------


def test_initialize_distributed_without_variables(monkeypatch):
    for key in ("COORDINATOR", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(f"WHATSHAP_TORCH_{key}", raising=False)
    assert mesh_mod.initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_one_process(monkeypatch):
    """With a coordinator on localhost, one process and rank 0, a gloo
    process group of one (no card here) is set up."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("WHATSHAP_TORCH_COORDINATOR", f"localhost:{port}")
    monkeypatch.setenv("WHATSHAP_TORCH_NUM_PROCESSES", "1")
    monkeypatch.setenv("WHATSHAP_TORCH_PROCESS_ID", "0")
    try:
        assert mesh_mod.initialize_distributed() is True
        assert torch.distributed.get_world_size() == 1
        assert torch.distributed.get_rank() == 0
        assert torch.distributed.get_backend() == ("nccl" if torch.cuda.is_available() else "gloo")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_entry_matches_reference():
    """entry() gives forward_cost_batched and its example batch, the
    reference entry's (__graft_entry__.py), on the CPU."""
    import __graft_entry__

    fn, args = dryrun.entry("cpu")
    ref_fn, ref_args = __graft_entry__.entry()
    for a, b in zip(args, ref_args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got, want = fn(*args), ref_fn(*ref_args)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).transpose(0, 2, 1))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]).transpose(0, 2, 1))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_dryrun_multichip_on_cpu_x4():
    """dryrun_multichip(4, "cpu") passes: the sharded solves against serial
    ones and the CLI over cpu x 4 against one device."""
    assert dryrun.dryrun_devices(4, "cpu") == [CPU] * 4
    dryrun.dryrun_multichip(4, "cpu")
    assert wmec.MESH_DEVICES is None
