"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no interpreter mode, so every test here needs a CUDA
device and skips without one.  On a machine with a card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The overlap kernel must also equal the tile kernel exactly (the same
tiles, scans and decode).

Tolerances: unit-weight ingest is bit-identical to the plain version (exact
integer masses); weighted histograms and counters agree to rtol 1e-5 (f32
sums over up to S terms, taken in another order) and a weighted call is
bit-identical to itself (no atomics); the ``sum`` column to
1e-5 * sum|v * w| (mixed signs cancel); quantile answers to rtol 1e-6 (the
same bucket; the decode's exp may differ by an ulp).
"""

import numpy as np
import pytest
import torch

from sketches_tpu_torch import batched, kernels
from sketches_tpu_torch.resilience import SketchValueError, SpecError

MAPPINGS = (
    "logarithmic",
    "linear_interpolated",
    "quadratic_interpolated",
    "cubic_interpolated",
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _values(n, s, seed, device):
    r = np.random.RandomState(seed)
    v = r.lognormal(0, 2, (n, s)) * np.where(r.rand(n, s) < 0.4, -1, 1)
    u = r.rand(n, s)
    v[u < 0.05] = 0.0
    v[(u > 0.05) & (u < 0.07)] = np.nan
    v[(u > 0.07) & (u < 0.09)] = 1e-40
    v[(u > 0.09) & (u < 0.11)] = 1e30
    v[:, :8] = 1.5
    return torch.from_numpy(v.astype(np.float32)).to(device)


def _rel_ok(a, b, rtol):
    a, b = a.double().cpu(), b.double().cpu()
    nan = torch.isnan(a) | torch.isnan(b)
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    return bool(((a - b).abs() <= rtol * b.abs())[~nan].all())


@pytest.mark.parametrize("mapping", MAPPINGS)
@pytest.mark.parametrize("n_bins", [512, 2048])
@pytest.mark.parametrize("weighted", [False, True])
def test_ingest_kernel_vs_plain(dev, mapping, n_bins, weighted):
    spec = batched.SketchSpec(0.01, mapping_name=mapping, n_bins=n_bins)
    n, s = 200, 256  # 200 rows: a ragged last block of warps
    v = _values(n, s, 1, dev)
    w = torch.rand((n, s), device=dev) * 3.0 - 0.5
    koff = torch.randint(-n_bins // 2 - 64, -n_bins // 2 + 64, (n,), device=dev,
                         dtype=torch.int32)
    before = kernels.ingest_histogram.launches
    got = kernels.ingest_histogram(spec, v, w if weighted else None, koff, weighted=weighted)
    assert kernels.ingest_histogram.launches == before + 1
    ref = kernels.ingest_histogram_plain(spec, v, w if weighted else None, koff,
                                         weighted=weighted)
    sc = kernels._COL["sum"]
    keep = [c for c in range(got[2].shape[1]) if c != sc]
    pairs = [(got[0], ref[0]), (got[1], ref[1]), (got[2][:, keep], ref[2][:, keep])]
    for a, b in pairs:
        if weighted:
            assert _rel_ok(a, b, 1e-5)
        else:
            assert torch.equal(a, b)
    wl = w if weighted else torch.ones_like(v)
    scale = torch.nansum(torch.where(wl > 0, v * wl, 0.0).abs(), dim=-1)
    a, b = got[2][:, sc], ref[2][:, sc]
    assert bool(((torch.isnan(a) & torch.isnan(b)) | ((a - b).abs() <= 1e-5 * scale)).all())
    if weighted:
        again = kernels.ingest_histogram(spec, v, w, koff, weighted=True)
        assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                    for x, y in zip(got, again))


def _state(spec, n, seed, dev, mixed):
    r = np.random.RandomState(seed)
    v = r.lognormal(0, 1.5, (n, 256))
    if mixed:
        v *= np.where(r.rand(n, 256) < 0.4, -1, 1)
    v = torch.from_numpy(v.astype(np.float32)).to(dev)
    st = batched.init(spec, n, dev)
    st = batched.recenter(spec, st, batched.auto_offset(spec, st, v))
    st = batched.add(spec, st, v)
    st.count = torch.where(torch.arange(n, device=dev) % 37 == 0, 0.0, st.count)
    return st


@pytest.mark.parametrize("w_tiles", [1, 2, 4])
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("n_q", [9, 40])
def test_windowed_kernel_vs_plain(dev, w_tiles, mixed, n_q):
    spec = batched.SketchSpec(0.01, n_bins=1024)
    st = _state(spec, 264, 2, dev, mixed)
    qs = torch.linspace(-0.1, 1.1, n_q, device=dev)
    glo, ghi = int(st.occ_lo.amin()), int(st.occ_hi.amax())
    lo_b = glo // 128 // w_tiles
    nwb = ghi // 128 // w_tiles - lo_b + 1
    before = kernels.fused_quantile_windowed.launches
    got = kernels.fused_quantile_windowed(spec, st, qs, lo_b, n_wblocks=nwb, w_tiles=w_tiles,
                                          with_neg=mixed)
    assert kernels.fused_quantile_windowed.launches == before + 1
    cpu = st.map(lambda t: t.cpu())
    ref = kernels.fused_quantile_windowed(spec, cpu, qs.cpu(), lo_b, n_wblocks=nwb,
                                          w_tiles=w_tiles, with_neg=mixed)
    assert _rel_ok(got, ref, 1e-6)
    assert _rel_ok(got, batched.quantile(spec, st, qs), 1e-6)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("n_q", [4, 9, 40])
def test_tiles_kernel_vs_plain(dev, mixed, n_q):
    spec = batched.SketchSpec(0.01, n_bins=1024)
    # 264 streams: a ragged last block; the tile plan needs 128-aligned
    # stream counts, so the bound is the widest one (every tile).
    st = _state(spec, 264, 3, dev, mixed)
    qs = torch.linspace(-0.1, 1.1, n_q, device=dev)
    k_tiles, with_neg = spec.n_tiles, mixed
    before = kernels.fused_quantile_tiles.launches
    got = kernels.fused_quantile_tiles(spec, st, qs, k_tiles=k_tiles, with_neg=with_neg)
    assert kernels.fused_quantile_tiles.launches == before + 1
    cpu = st.map(lambda t: t.cpu())
    ref = kernels.fused_quantile_tiles(spec, cpu, qs.cpu(), k_tiles=k_tiles, with_neg=with_neg)
    assert _rel_ok(got, ref, 1e-6)
    assert _rel_ok(got, batched.quantile(spec, st, qs), 1e-6)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("n_bins", [512, 2048, 300])
@pytest.mark.parametrize("n_q", [4, 40])
def test_quantile_kernel_vs_plain(dev, mixed, n_bins, n_q):
    spec = batched.SketchSpec(0.01, n_bins=n_bins)
    st = _state(spec, 264, 5, dev, mixed)
    qs = torch.linspace(-0.1, 1.1, n_q, device=dev)
    before = kernels.fused_quantile.launches
    got = kernels.fused_quantile(spec, st, qs)
    assert kernels.fused_quantile.launches == before + 1
    cpu = st.map(lambda t: t.cpu())
    assert _rel_ok(got, kernels.fused_quantile(spec, cpu, qs.cpu()), 1e-6)
    assert _rel_ok(got, batched.quantile(spec, st, qs), 1e-6)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("lookahead", [1, 2, 8])
@pytest.mark.parametrize("block_streams", [0, 256])
def test_overlap_kernel_vs_plain(dev, mixed, lookahead, block_streams):
    spec = batched.SketchSpec(0.01, n_bins=1024)
    st = _state(spec, 1024, 6, dev, mixed)
    qs = torch.tensor([0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0, -0.1], device=dev)
    k_tiles, with_neg = kernels.plan_tile_query(spec, st, qs)
    cpu = st.map(lambda t: t.cpu())
    for wn in {with_neg, True}:
        for k in {k_tiles, spec.n_tiles}:
            before = kernels.fused_quantile_tiles_overlap.launches
            got = kernels.fused_quantile_tiles_overlap(
                spec, st, qs, k_tiles=k, with_neg=wn, block_streams=block_streams,
                lookahead=lookahead)
            assert kernels.fused_quantile_tiles_overlap.launches == before + 1
            ref = kernels.fused_quantile_tiles_overlap(
                spec, cpu, qs.cpu(), k_tiles=k, with_neg=wn, block_streams=block_streams,
                lookahead=lookahead)
            assert _rel_ok(got, ref, 1e-6)
            tiles = kernels.fused_quantile_tiles(spec, st, qs, k_tiles=k, with_neg=wn)
            assert torch.equal(torch.isnan(got), torch.isnan(tiles))
            assert torch.equal(got.nan_to_num(), tiles.nan_to_num())


def test_overlap_kernel_honours_short_lists(dev):
    """With k_tiles below a block's needed-tile union, ranks whose tile is
    not listed fold a zero tile -- the TPU kernel's contract, which the
    plain version repeats."""
    spec = batched.SketchSpec(0.01, n_bins=1024)
    st = _state(spec, 512, 7, dev, True)
    qs = torch.tensor([0.1, 0.5, 0.9, 0.99], device=dev)
    got = kernels.fused_quantile_tiles_overlap(spec, st, qs, k_tiles=1, lookahead=2)
    cpu = st.map(lambda t: t.cpu())
    ref = kernels.fused_quantile_tiles_overlap(spec, cpu, qs.cpu(), k_tiles=1, lookahead=2)
    assert _rel_ok(got, ref, 1e-6)


def test_wrapper_rejects_bad_operands(dev):
    too_wide = batched.SketchSpec(0.01, n_bins=30720)  # 240 KB of histograms a stream
    with pytest.raises(SpecError):
        kernels.ingest_histogram(too_wide, torch.ones((128, 128), device=dev), None,
                                 torch.zeros(128, dtype=torch.int32, device=dev),
                                 weighted=False)
    spec = batched.SketchSpec(0.01, n_bins=512)
    v = torch.ones((128, 128), device=dev)
    koff = torch.zeros(128, dtype=torch.int64, device=dev)
    with pytest.raises(SketchValueError):
        kernels.ingest_histogram(spec, v, None, koff, weighted=False)
    with pytest.raises(SketchValueError):
        kernels.ingest_histogram(spec, v.t(), None, koff.to(torch.int32), weighted=False)


def test_facade_routes_through_kernels(dev):
    sk = batched.BatchedDDSketch(1024, relative_accuracy=0.01, n_bins=512)
    assert sk.device.type == "cuda" and sk.engine == "kernel"
    r = np.random.RandomState(4)
    kernels.reset_launch_counts()
    for _ in range(3):
        sk.add(r.lognormal(0, 2, (1024, 256)).astype(np.float32))
    qs = [0.5, 0.9, 0.99, 0.999]
    tier, vals = sk.get_quantile_values_resolved(qs)
    counts = kernels.launch_counts()
    assert tier == "overlap" and counts["fused_quantile_tiles_overlap"] == 1
    assert counts["ingest_histogram"] == 2  # the first batch auto-centres
    assert bool(torch.isfinite(vals).all())
    tier, again = sk.get_quantile_values_resolved(qs, disabled_tiers=("overlap",))
    assert tier == "windowed" and kernels.launch_counts()["fused_quantile_windowed"] == 1
    assert torch.equal(vals, again)
