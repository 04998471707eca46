"""Worker process for the port's multi-process drills (``test_torch_multihost.py``).

Run as: python _torch_multihost_worker.py <rendezvous_file> <rank> <n_procs>
        <out_dir> [mode]

Each process joins a gloo job through ``file://<rendezvous_file>``
(``torch.distributed.init_process_group``), puts 4 ``"cpu"`` cells into the
job-wide mesh with ``make_global_mesh``, and folds its partials across the
process boundary with the collective ``psum_merge`` -- the port's
counterpart of ``tests/_multihost_worker.py``, with the same sizes, seeds
and assertions.  It imports torch and the port only.

``mode``:

* ``base``: 1-D ``("values",)`` mesh, RandomState(0) normal(50, 5)
  ``[8, 4, 64]``; the fold is written to ``fold<rank>.npz``; telemetry
  armed, a facade workload plus ``10**rank * (1..32)`` ms ``query_s``
  observations written to ``snap<rank>.json``.
* ``elastic``: the hierarchical ``("dcn", "ici")`` mesh with hosts derived
  from the processes, RandomState(1) normal(40, 4); the fold to
  ``fold<rank>.npz``, this process's own merged partial to
  ``partial<rank>.npz`` for the parent's ``fold_hosts``.
* ``grid``: one ``"cpu"`` cell a rank and two hosts, so the inner axis
  crosses processes (one group per host and one per local index); the
  base data; the fold to ``fold<rank>.npz``.
* ``fabric``: every process drives the same ``ServeFabric`` op log
  (default_rng(17)) through a primary kill and failover, and the job
  all-gathers the promoted fingerprint and the answers; the verdict goes to
  ``fabric<rank>.json``.

Prints ``MULTIHOST_OK rank=<rank>`` on success.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOCAL_DEVICES = 4
ALPHA = 0.01


def _spec():
    from sketches_tpu_torch.batched import SketchSpec

    return SketchSpec(relative_accuracy=ALPHA, n_bins=512)


def _partials(spec, all_vals, rank, local):
    import torch

    from sketches_tpu_torch.batched import add, init

    n_streams = all_vals.shape[1]
    return [
        add(spec, init(spec, n_streams, "cpu"), torch.from_numpy(all_vals[rank * local + i]))
        for i in range(local)
    ]


def _check_alpha(spec, folded, all_vals, qs):
    import numpy as np

    from sketches_tpu_torch.batched import quantile

    n_streams = all_vals.shape[1]
    got = quantile(spec, folded, qs).numpy()
    union = all_vals.transpose(1, 0, 2).reshape(n_streams, -1)
    for i in range(n_streams):
        for j, q in enumerate(qs):
            exact = np.quantile(union[i], q, method="lower")
            assert abs(got[i, j] - exact) <= 0.0101 * abs(exact) + 1e-6, (i, q, got[i, j], exact)


def base_main(rank, nproc, out_dir, mode):
    import numpy as np

    from sketches_tpu_torch import checkpoint
    from sketches_tpu_torch.parallel import make_global_mesh, psum_merge

    spec = _spec()
    n_streams, chunk = 4, 64
    local = 1 if mode == "grid" else LOCAL_DEVICES
    n_shards = nproc * local
    if mode == "grid":
        from sketches_tpu_torch.parallel import make_hierarchical_mesh

        g = make_global_mesh(("values",), devices=["cpu"])
        mesh = make_hierarchical_mesh(n_hosts=2, devices=g.devices, ranks=g.ranks)
        axis = ("dcn", "ici")
        built = mesh.build()
        assert built.shape == {"dcn": 2, "ici": nproc // 2}, built.shape
    else:
        mesh = make_global_mesh(("values",), devices=["cpu"] * local)
        axis = "values"
        built = mesh.build()
        assert built.devices.size == n_shards and built.shape == {"values": n_shards}
    assert built.ranks.reshape(-1).tolist() == [r for r in range(nproc) for _ in range(local)]

    # Same deterministic dataset on every process; each of the global cells
    # ingests its own [n_streams, chunk] slice of the value stream.
    all_vals = (
        np.random.RandomState(0).normal(50.0, 5.0, (n_shards, n_streams, chunk)).astype(np.float32)
    )
    folded = psum_merge(_partials(spec, all_vals, rank, local), axis_name=axis, mesh=mesh)
    assert folded.count.tolist() == [n_shards * chunk] * n_streams
    _check_alpha(spec, folded, all_vals, (0.25, 0.5, 0.75))
    checkpoint.save_state(os.path.join(out_dir, f"fold{rank}.npz"), spec, folded)
    if mode == "grid":
        return

    from sketches_tpu_torch import telemetry
    from sketches_tpu_torch.batched import BatchedDDSketch

    # A facade workload so the instrumented seams record, plus a
    # deterministic per-process latency series: process p observes
    # 10**p * (1..32) ms, so the parent can check the merged histogram's
    # quantiles against the exact union.
    telemetry.enable()
    telemetry.reset()
    facade = BatchedDDSketch(n_streams, spec=spec, device="cpu")
    facade.add(all_vals[rank * local])
    facade.get_quantile_values([0.5, 0.99])
    for k in range(1, 33):
        telemetry.observe("query_s", k * 1e-3 * (10.0**rank), component="mh")
    with open(os.path.join(out_dir, f"snap{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(telemetry.snapshot(), f, indent=1, sort_keys=True)
        f.write("\n")


def elastic_main(rank, nproc, out_dir):
    """The hierarchical fold drill: a job-wide ("dcn", "ici") mesh, the
    chained fold, and this process's merged partial checkpointed for the
    parent's ``fold_hosts``."""
    import numpy as np
    import torch

    from sketches_tpu_torch import checkpoint
    from sketches_tpu_torch.batched import add, init
    from sketches_tpu_torch.parallel import make_global_mesh, make_hierarchical_mesh, psum_merge

    spec = _spec()
    n_shards = nproc * LOCAL_DEVICES
    n_streams, chunk = 4, 64
    g = make_global_mesh(("values",), devices=["cpu"] * LOCAL_DEVICES)
    sm = make_hierarchical_mesh(devices=g.devices, ranks=g.ranks)  # hosts from the processes
    assert sm.n_hosts == nproc, sm
    built = sm.build()
    assert built.shape == {"dcn": nproc, "ici": LOCAL_DEVICES}, built.shape
    all_vals = (
        np.random.RandomState(1).normal(40.0, 4.0, (n_shards, n_streams, chunk)).astype(np.float32)
    )
    # ICI first (this process's cells), then across the processes.
    folded = psum_merge(
        _partials(spec, all_vals, rank, LOCAL_DEVICES), axis_name=("dcn", "ici"), mesh=sm
    )
    assert folded.count.tolist() == [n_shards * chunk] * n_streams
    _check_alpha(spec, folded, all_vals, (0.5,))
    checkpoint.save_state(os.path.join(out_dir, f"fold{rank}.npz"), spec, folded)

    # The per-host partial the elastic protocol ships: this process's own
    # shards, folded locally, checkpointed for the parent.
    local = all_vals[rank * LOCAL_DEVICES : (rank + 1) * LOCAL_DEVICES]
    local_state = add(
        spec,
        init(spec, n_streams, "cpu"),
        torch.from_numpy(np.ascontiguousarray(local.transpose(1, 0, 2).reshape(n_streams, -1))),
    )
    checkpoint.save_state(os.path.join(out_dir, f"partial{rank}.npz"), spec, local_state)


def fabric_main(rank, nproc, out_dir):
    """The serve-fabric drill: every process drives an identical fabric
    through one deterministic op log (ingest, replica sync, a primary kill
    mid-ingest, failover); the job all-gathers the promoted fingerprints
    and the served answers, which must be bit-identical everywhere."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sketches_tpu_torch.batched import SketchSpec
    from sketches_tpu_torch.fabric import FabricConfig, ServeFabric
    from sketches_tpu_torch.windows import VirtualClock

    n_streams, chunk = 4, 32
    spec = SketchSpec(relative_accuracy=0.02, n_bins=128)
    fab = ServeFabric(
        FabricConfig(n_hosts=4, replication=3, staleness_s=600.0), clock=VirtualClock(0.0)
    )
    fab.add_tenant("t", n_streams, spec=spec, device="cpu")
    rng = np.random.default_rng(17)  # the same stream on every process
    for _ in range(3):
        fab.ingest("t", rng.lognormal(0.0, 0.7, (n_streams, chunk)).astype(np.float32))
    assert fab.sync("t") == 2
    # Mass past the sync point: exactly what the failover must itemize.
    fab.ingest("t", rng.lognormal(0.0, 0.7, (n_streams, chunk)).astype(np.float32))
    primary = fab.placement("t")[0]
    reports = fab.kill_host(primary)
    assert len(reports) == 1 and reports[0].tenant == "t"
    assert reports[0].exact
    assert np.array_equal(reports[0].dropped_count, np.full(n_streams, float(chunk)))
    led = fab.ledger("t")
    assert led["expected_total"] + led["dropped_total"] == 4.0 * n_streams * chunk
    res = fab.quantile("t", (0.5, 0.99))
    assert res.role in ("primary", "cache")

    # Fingerprint-verified convergence across the processes.
    fp = torch.frombuffer(bytearray(bytes.fromhex(led["fingerprint"])), dtype=torch.uint8)
    gathered = [torch.empty_like(fp) for _ in range(nproc)]
    dist.all_gather(gathered, fp)
    assert all(torch.equal(x, gathered[0]) for x in gathered), "fingerprints diverged"
    vals = np.asarray(res.values, np.float64)
    answers: list = [None] * nproc
    dist.all_gather_object(answers, vals.tobytes())
    assert len(set(answers)) == 1, "post-failover answers diverged across processes"
    with open(os.path.join(out_dir, f"fabric{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(
            {
                "fingerprint": led["fingerprint"],
                "from_host": reports[0].from_host,
                "to_host": reports[0].to_host,
                "dropped_total": float(reports[0].dropped_total),
                "expected_total": led["expected_total"],
                "values": vals.tolist(),
            },
            f, indent=1, sort_keys=True,
        )
        f.write("\n")


def main() -> None:
    rdv, rank, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    out_dir = sys.argv[4]
    mode = sys.argv[5] if len(sys.argv) > 5 else "base"
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=nproc, rank=rank)
    assert dist.get_world_size() == nproc and dist.get_backend() == "gloo"
    if mode == "elastic":
        elastic_main(rank, nproc, out_dir)
    elif mode == "fabric":
        fabric_main(rank, nproc, out_dir)
    else:
        base_main(rank, nproc, out_dir, mode)
    dist.barrier()
    dist.destroy_process_group()
    print(f"MULTIHOST_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
