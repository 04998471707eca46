"""The port's multi-process mesh over ``torch.distributed`` (gloo), on the CPU.

The port's counterparts of ``tests/test_multihost.py``'s three drills --
the 2-process psum merge, the 2-process hierarchical fold with elastic
resume, the 3-process fabric failover -- with the same sizes, seeds and
assertions, plus a 4-process layout whose inner axis crosses processes.
Each drill starts fresh interpreters (``tests/_torch_multihost_worker.py``)
that join one gloo job through a ``file://`` rendezvous under
``tmp_path`` (no TCP port to race for), each with 4 ``"cpu"`` cells.

The JAX drills skip here (CPU jaxlib has no multiprocess collectives), so
the port's collective fold is also held to the JAX package's
single-process results on the union of the data: bins, counts, offsets and
occupied bounds bit-equal, ``sum`` within 1e-5 of the sum of |v| (f32 sums
in another order).  The elastic drill's checkpoints are written by the port
and restored by both packages.

A worker assertion, a non-zero exit or a hang past the drill's 60-s limit
fails; only a torch without gloo skips, with the transcript.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch.distributed as dist
from torch_worker_common import jax_compile_cache, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_compile_cache")

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_worker.py")
_TIMEOUT_S = 60
_EXACT = ("bins_pos", "bins_neg", "zero_count", "count", "min", "max", "collapsed_low",
          "collapsed_high", "key_offset", "pos_lo", "pos_hi", "neg_lo", "neg_hi",
          "neg_total", "tile_sums")


def _run_workers(tmp_path, mode, n_procs=2):
    """Start ``n_procs`` workers in ``mode`` and wait for all of them ->
    their outputs; fails with the transcript on any failure or a hang."""
    if not dist.is_gloo_available():
        pytest.skip("this torch has no gloo backend: the drill cannot run")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    rdv = tmp_path / "rendezvous"
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(rdv), str(r), str(n_procs), str(tmp_path), mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(n_procs)
    ]
    deadline = time.monotonic() + _TIMEOUT_S
    outs, hung = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            hung = True
            p.kill()
            out, _ = p.communicate(timeout=30)
        outs.append(out)
    transcript = "\n".join(
        f"--- worker {i} (rc={p.returncode}) ---\n{o}" for i, (p, o) in enumerate(zip(procs, outs))
    )
    assert not hung, f"a worker passed the {_TIMEOUT_S}-s limit:\n{transcript}"
    assert all(p.returncode == 0 for p in procs), transcript
    assert all(f"MULTIHOST_OK rank={i}" in outs[i] for i in range(n_procs)), transcript
    return outs


def _port_state(path):
    from sketches_tpu_torch import checkpoint

    return checkpoint.restore_state(str(path), device="cpu")


def _assert_equal_states(port, ref, scale):
    """A port state against a JAX one: exact leaves bit-equal, ``sum``
    within ``1e-5 * scale``."""
    for f in _EXACT:
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_allclose(port.sum.numpy(), np.asarray(ref.sum), rtol=0, atol=1e-5 * scale)


def _jax_union_state(all_vals):
    """The JAX package's single-process sketch of every cell's values."""
    import jax.numpy as jnp

    from sketches_tpu import batched as jb

    n_streams = all_vals.shape[1]
    union = all_vals.transpose(1, 0, 2).reshape(n_streams, -1)
    spec = jb.SketchSpec(relative_accuracy=0.01, n_bins=512)
    return jb.add(spec, jb.init(spec, n_streams), jnp.asarray(union))


def _assert_folds(tmp_path, n_procs, all_vals):
    """Every process's fold equals every other's and the JAX package's
    single-process sketch of the union."""
    ref = _jax_union_state(all_vals)
    scale = float(np.abs(all_vals).sum())
    spec0, first = _port_state(tmp_path / "fold0.npz")
    for r in range(n_procs):
        spec, state = _port_state(tmp_path / f"fold{r}.npz")
        assert spec == spec0
        for f in _EXACT + ("sum",):
            np.testing.assert_array_equal(getattr(state, f).numpy(), getattr(first, f).numpy())
        _assert_equal_states(state, ref, scale)


def _base_values(n_shards):
    return np.random.RandomState(0).normal(50.0, 5.0, (n_shards, 4, 64)).astype(np.float32)


def test_two_process_global_mesh_psum_merge(tmp_path):
    _run_workers(tmp_path, "base")
    _assert_folds(tmp_path, 2, _base_values(8))

    # Fleet aggregation: the two processes' telemetry snapshots merge;
    # counters sum exactly and the merged histogram's quantiles agree with
    # the exact union of both processes' observations.
    from sketches_tpu_torch import telemetry

    snaps = []
    for r in range(2):
        with open(tmp_path / f"snap{r}.json", encoding="utf-8") as f:
            snaps.append(json.load(f))
    merged = telemetry.merge_snapshots(*snaps)
    assert merged["merged_from"] == 2
    for key in snaps[0]["counters"]:
        expected = sum(s["counters"].get(key, 0.0) for s in snaps)
        assert merged["counters"][key] == pytest.approx(expected)
    exact = np.asarray([k * 1e-3 * (10.0**r) for r in range(2) for k in range(1, 33)])
    summary = merged["histograms"]['query_s{component="mh"}']
    assert summary["count"] == exact.size
    alpha = merged["histogram_relative_accuracy"]
    for q, label in ((0.5, "p50"), (0.99, "p99")):
        want = np.quantile(exact, q, method="lower")
        assert abs(summary[label] - want) <= 2 * alpha * abs(want) + 1e-9, (label, summary[label])


def test_four_process_grid_inner_axis_crosses_processes(tmp_path):
    """One cell a process and two hosts: the inner axis's lines are
    processes {0, 1} and {2, 3}, the outer axis's {0, 2} and {1, 3}, so the
    fold runs two collectives, each on a group of its own."""
    _run_workers(tmp_path, "grid", n_procs=4)
    _assert_folds(tmp_path, 4, _base_values(4))


def test_two_process_hierarchical_fold_and_elastic_resume(tmp_path):
    """The hierarchical ("dcn", "ici") fold across a real process boundary;
    the per-process partials, checkpointed by the port, fold with
    ``fold_hosts`` in both packages, and one resumes onto another mesh."""
    _run_workers(tmp_path, "elastic")
    all_vals = np.random.RandomState(1).normal(40.0, 4.0, (8, 4, 64)).astype(np.float32)
    _assert_folds(tmp_path, 2, all_vals)

    import jax.numpy as jnp

    from sketches_tpu import checkpoint as jck
    from sketches_tpu import parallel as jp
    from sketches_tpu.batched import quantile as jquantile
    from sketches_tpu_torch.batched import quantile
    from sketches_tpu_torch.parallel import DistributedDDSketch, SketchMesh, fold_hosts

    n_shards, n_streams, chunk = 8, 4, 64
    states, jstates, spec = [], [], None
    for r in range(2):
        spec, state = _port_state(tmp_path / f"partial{r}.npz")
        states.append(state)
        jspec, jstate = jck.restore_state(str(tmp_path / f"partial{r}.npz"))
        jstates.append(jstate)
    folded, report = fold_hosts(spec, states)
    assert report.n_dead == 0
    assert folded.count.tolist() == [n_shards * chunk] * n_streams
    jfolded, jreport = jp.fold_hosts(jspec, jstates)
    assert jreport.n_dead == 0
    _assert_equal_states(folded, jfolded, float(np.abs(all_vals).sum()))
    _assert_equal_states(folded, _jax_union_state(all_vals), float(np.abs(all_vals).sum()))
    union = all_vals.transpose(1, 0, 2).reshape(n_streams, -1)
    got = quantile(spec, folded, [0.5, 0.99]).numpy()
    for i in range(n_streams):
        for j, q in enumerate((0.5, 0.99)):
            exact = np.quantile(union[i], q, method="lower")
            assert abs(got[i, j] - exact) <= 0.0101 * abs(exact) + 1e-6
    np.testing.assert_allclose(
        got, np.asarray(jquantile(jspec, jfolded, jnp.asarray([0.5, 0.99]))), rtol=1e-6
    )
    # Elastic resume: one process's partial regrows onto a 2-cell mesh here
    # (the state is topology-free) and keeps ingesting.
    back = DistributedDDSketch.from_merged_state(
        states[0], spec, mesh=SketchMesh(2, devices=["cpu"] * 2)
    )
    assert back.count.tolist() == [4 * chunk] * n_streams
    back.add(np.ones((n_streams, 16), np.float32))
    assert back.count.tolist() == [4 * chunk + 16] * n_streams


def _jax_fabric_run():
    """The fabric drill's op log through the JAX package, in this process."""
    from sketches_tpu.batched import SketchSpec
    from sketches_tpu.fabric import FabricConfig, ServeFabric
    from sketches_tpu.windows import VirtualClock

    fab = ServeFabric(FabricConfig(n_hosts=4, replication=3, staleness_s=600.0),
                      clock=VirtualClock(0.0))
    fab.add_tenant("t", 4, spec=SketchSpec(relative_accuracy=0.02, n_bins=128))
    rng = np.random.default_rng(17)
    for _ in range(3):
        fab.ingest("t", rng.lognormal(0.0, 0.7, (4, 32)).astype(np.float32))
    fab.sync("t")
    fab.ingest("t", rng.lognormal(0.0, 0.7, (4, 32)).astype(np.float32))
    (rep,) = fab.kill_host(fab.placement("t")[0])
    return rep, fab.ledger("t"), fab.quantile("t", (0.5, 0.99))


def test_three_process_fabric_failover_convergence(tmp_path):
    """Three processes replay one fabric op log through a primary kill and
    failover and all-gather the promoted fingerprint and the answers: one
    fingerprint, one failover, the dropped mass itemized exactly, and the
    JAX package's fabric agrees on the same log."""
    _run_workers(tmp_path, "fabric", n_procs=3)
    verdicts = []
    for r in range(3):
        with open(tmp_path / f"fabric{r}.json", encoding="utf-8") as f:
            verdicts.append(json.load(f))
    assert len({v["fingerprint"] for v in verdicts}) == 1
    assert len({(v["from_host"], v["to_host"]) for v in verdicts}) == 1
    assert all(v["dropped_total"] == 4 * 32.0 for v in verdicts)
    assert all(v["expected_total"] == 3 * 4 * 32.0 for v in verdicts)
    assert all(v["values"] == verdicts[0]["values"] for v in verdicts)

    rep, led, res = _jax_fabric_run()
    v = verdicts[0]
    assert (v["fingerprint"], v["from_host"], v["to_host"]) == (
        led["fingerprint"], rep.from_host, rep.to_host)
    assert v["dropped_total"] == float(rep.dropped_total)
    np.testing.assert_allclose(v["values"], np.asarray(res.values, np.float64), rtol=1e-6)


# ---------------------------------------------------------------------------
# In one process: the layout rules and the collective form's edges
# ---------------------------------------------------------------------------


def _cpu_partials(k, seed=0):
    import torch

    from sketches_tpu_torch.batched import SketchSpec, add, init

    spec = SketchSpec(relative_accuracy=0.01, n_bins=512)
    vals = np.random.RandomState(seed).lognormal(0, 1, (k, 4, 64)).astype(np.float32)
    return spec, [add(spec, init(spec, 4, "cpu"), torch.from_numpy(v)) for v in vals]


def test_make_global_mesh_needs_a_process_group():
    from sketches_tpu_torch.parallel import make_global_mesh
    from sketches_tpu_torch.resilience import SpecError

    assert not dist.is_initialized()
    with pytest.raises(SpecError, match="init_process_group"):
        make_global_mesh(("values",), devices=["cpu"])


def test_hosts_derive_from_the_ranks_as_jax_derives_them_from_processes():
    import jax

    from sketches_tpu import parallel as jp
    from sketches_tpu_torch import parallel as tp

    two = tp.make_hierarchical_mesh(devices=["cpu"] * 8, ranks=[0] * 4 + [1] * 4)
    assert two.n_hosts == 2 and two.build().shape == {"dcn": 2, "ici": 4}
    # Three processes do not divide four value shards: one host (JAX's rule).
    assert tp.SketchMesh(devices=["cpu"] * 4, ranks=[0, 0, 1, 2]).n_hosts == 1
    assert tp.SketchMesh(devices=["cpu"] * 4).n_hosts == 1
    # Resizing keeps the host grouping where it divides (JAX's rule).
    assert two.resized(4).ranks == (0, 0, 0, 0) and two.resized(4).n_hosts == 2
    assert two.resized(4, devices=["cpu"] * 4).ranks == (0,) * 4
    # One process: the built shapes and axis orders are the JAX package's.
    jd = jax.devices()
    for jm, tm in (
        (jp.make_hierarchical_mesh(n_hosts=2, devices=jd[:4]),
         tp.make_hierarchical_mesh(n_hosts=2, devices=["cpu"] * 4)),
        (jp.SketchMesh(8, devices=jd, stream_axis="streams", stream_shards=2),
         tp.SketchMesh(8, devices=["cpu"] * 8, stream_axis="streams", stream_shards=2)),
        (jp.SketchMesh(4, devices=jd[:4]), tp.SketchMesh(4, devices=["cpu"] * 4)),
    ):
        jb, tb_ = jm.build(), tm.build()
        assert tuple(jb.axis_names) == tb_.axis_names and dict(jb.shape) == tb_.shape
        assert tb_.groups == {} and tm.build() is tb_


def test_build_refuses_cells_not_in_rank_blocks():
    from sketches_tpu_torch.parallel import SketchMesh
    from sketches_tpu_torch.resilience import SpecError

    # Interleaved, unequal, and blocks of 3 over lines of 2.
    for ranks, hosts in (([0, 1, 0, 1], 1), ([0, 0, 0, 1], 1), ([0, 0, 0, 1, 1, 1], 3)):
        m = SketchMesh(devices=["cpu"] * len(ranks), ranks=ranks, value_axis=("dcn", "ici"),
                       n_hosts=hosts)
        with pytest.raises(SpecError, match="blocks"):
            m.build()
    # Blocks of 3 over lines of 3 are whole lines.
    SketchMesh(devices=["cpu"] * 6, ranks=[0, 0, 0, 1, 1, 1], value_axis=("dcn", "ici")).build()


def test_collective_form_in_one_process_is_the_list_fold():
    import torch

    from sketches_tpu_torch.batched import LEAVES
    from sketches_tpu_torch.parallel import make_hierarchical_mesh, psum_merge
    from sketches_tpu_torch.resilience import SpecError

    spec, parts = _cpu_partials(4)
    mesh = make_hierarchical_mesh(n_hosts=2, devices=["cpu"] * 4)
    got = psum_merge(parts, axis_name=("dcn", "ici"), mesh=mesh)
    want = psum_merge(parts, n_hosts=2)
    for f in LEAVES:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(SpecError, match="owns 4 cells"):
        psum_merge(parts[:3], axis_name=("dcn", "ici"), mesh=mesh)
    with pytest.raises(SpecError, match="lack"):
        psum_merge(parts, axis_name="values", mesh=mesh)
    with pytest.raises(SpecError, match="more than one position"):
        psum_merge(parts, axis_name="ici", mesh=mesh)
    with pytest.raises(SpecError, match="both"):
        psum_merge(parts, axis_name="dcn")


def test_world_of_one_fold_leaves_the_state_bit_equal(tmp_path):
    """A process group of one rank (the card check's NCCL world, here on
    gloo): ``make_global_mesh`` and the collective fold run one all_reduce
    a leaf on the default group and change nothing."""
    if not dist.is_gloo_available():
        pytest.skip("this torch has no gloo backend")
    import torch

    from sketches_tpu_torch.batched import LEAVES
    from sketches_tpu_torch.parallel import make_global_mesh, psum_merge

    spec, (state,) = _cpu_partials(1, seed=3)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1, rank=0)
    try:
        mesh = make_global_mesh(("values",), devices=["cpu"])
        built = mesh.build()
        assert built.shape == {"values": 1} and built.groups == {(0,): dist.group.WORLD}
        before = state.map(torch.clone)
        got = psum_merge(state, axis_name="values", mesh=mesh)
        for f in LEAVES:
            assert torch.equal(getattr(got, f), getattr(before, f)), f
            assert torch.equal(getattr(state, f), getattr(before, f)), f
            assert getattr(got, f).data_ptr() != getattr(state, f).data_ptr()
    finally:
        dist.destroy_process_group()
