"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no interpreter mode, so every test here needs a CUDA
device and skips without one.  On a machine with a card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The overlap kernel must also equal the tile kernel exactly (the same
tiles, scans and decode), and a full-window launch a second one bit for
bit.

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
from hypothesis import given

from sketches_tpu_torch import batched, convert, kernels, resilience
from sketches_tpu_torch.resilience import SketchValueError, SpecError
from torch_edge_rows import EDGE_QS, edge_leaves
from torch_property_common import SEEDS, WINDOW_STREAMS, finite_f32, padded_block, steady, with_mid

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


def _unexpected_downgrades() -> list:
    """The ledger's downgrades but the native kill switch's, which a caller
    turns on deliberately and which is recorded as such."""
    return [e for e in resilience.health()["downgrades"]
            if not e["reason"].startswith("disabled via SKETCHES_TPU_NATIVE=0")]


#: Un-armed card tests that left a downgrade behind (name -> events).
_LEAKED: dict = {}


@pytest.fixture
def armed():
    """Marks a test that arms a fault site: the ledger is its to fill, and
    it is cleared (faults disarmed) before and after the test."""
    from sketches_tpu_torch import faults

    faults.disarm()
    resilience.reset()
    yield
    faults.disarm()
    resilience.reset()


@pytest.fixture(autouse=True)
def _no_downgrade_unless_armed(request):
    """Every test that arms nothing must leave no new downgrade: on the card
    a kernel is never replaced by its plain version without a trace."""
    if "armed" in request.fixturenames:
        yield
        return
    before = len(_unexpected_downgrades())
    yield
    if "dev" not in request.fixturenames or not torch.cuda.is_available():
        return
    left = _unexpected_downgrades()[before:]
    if left:
        _LEAKED[request.node.name] = left
    assert left == [], f"{request.node.name} recorded a downgrade un-armed: {left}"


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
    return bool(((a == b) | ((a - b).abs() <= rtol * b.abs()))[~nan].all())


def _ingest_matches_plain(spec, v, koff, weighted, w=None):
    """One ingest launch against the plain version: unit weights bit for
    bit (the sum column to 1e-5 * sum|v|), weighted to rtol 1e-5 and
    bit-identical to a second launch."""
    before = kernels.ingest_histogram.launches
    got = kernels.ingest_histogram(spec, v, w, koff, weighted=weighted)
    assert kernels.ingest_histogram.launches == before + 1
    ref = kernels.ingest_histogram_plain(spec, v, w, koff, weighted=weighted)
    sc = kernels._COL["sum"]
    keep = [c for c in range(got[2].shape[1]) if c != sc]
    for a, b in [(got[0], ref[0]), (got[1], ref[1]), (got[2][:, keep], ref[2][:, keep])]:
        assert _rel_ok(a, b, 1e-5) if weighted else torch.equal(a, b)
    wl = w if weighted else torch.ones_like(v)
    scale = torch.nansum(torch.where(wl > 0, v * wl, 0.0).abs(), dim=-1)
    a, b = got[2][:, sc], ref[2][:, sc]
    assert bool(((torch.isnan(a) & torch.isnan(b)) | ((a - b).abs() <= 1e-5 * scale)).all())
    if weighted:
        again = kernels.ingest_histogram(spec, v, w, koff, weighted=True)
        assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(got, again))


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
    _ingest_matches_plain(spec, v, koff, weighted, w if weighted else None)


@pytest.mark.parametrize("batch", ["one_bucket", "skewed"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ingest_kernel_heavy_skew(dev, batch, weighted):
    """Every value in one bin (each 32-value step adds 32 at once), and
    traffic where most values share a few bins (atomics contend)."""
    spec = batched.SketchSpec(0.01, n_bins=512)
    n, s = 1000, 256
    r = np.random.RandomState(8)
    if batch == "one_bucket":
        v = np.full((n, s), 3.7)
        v[5::7] = -3.7
    else:
        v = np.where(r.rand(n, s) < 0.9, 2.0, r.lognormal(0, 2, (n, s)))
        v[:, 100:140] = 2.0  # whole steps in one bin, mid-row
    v = torch.from_numpy(v.astype(np.float32)).to(dev)
    koff = torch.full((n,), -256, dtype=torch.int32, device=dev)
    w = torch.from_numpy(r.rand(n, s).astype(np.float32) * 2.0).to(dev)
    _ingest_matches_plain(spec, v, koff, weighted, w if weighted else None)


@pytest.mark.parametrize("s", [1, 31, 200, 257, 600])
@pytest.mark.parametrize("weighted", [False, True])
def test_ingest_kernel_ragged(dev, s, weighted):
    """A batch width that is no multiple of the 32-value step or of the
    256-value chunk (S > 256 takes several chunks a row), and a row count
    that leaves the last block of warps part empty."""
    spec = batched.SketchSpec(0.01, mapping_name="cubic_interpolated", n_bins=1024)
    n = 1001
    v = _values(n, s, 9, dev)
    koff = torch.randint(-576, -448, (n,), device=dev, dtype=torch.int32)
    w = torch.rand((n, s), device=dev) * 3.0 - 0.5
    _ingest_matches_plain(spec, v, koff, weighted, w if weighted else None)


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


def _quantile_matches_plain(spec, st, qs):
    """One full-window launch against the plain version (on the CPU) and
    ``batched.quantile``, rtol 1e-6 with equal NaN positions; a second
    launch equal bit for bit."""
    before = kernels.fused_quantile.launches
    got = kernels.fused_quantile(spec, st, qs)
    assert kernels.fused_quantile.launches == before + 1
    cpu = st.map(lambda t: t.cpu())
    assert _rel_ok(got, kernels.fused_quantile(spec, cpu, qs.cpu()), 1e-6)
    assert _rel_ok(got, batched.quantile(spec, st, qs), 1e-6)
    again = kernels.fused_quantile(spec, st, qs)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("n_bins", [512, 2048, 300, 129])
@pytest.mark.parametrize("n", [1, 5, 264, 40000])
@pytest.mark.parametrize("n_q", [1, 4, 40])
def test_quantile_kernel_vs_plain(dev, mixed, n_bins, n, n_q):
    """Widths that are no multiple of 128 (300) or of 4 (129: four streams
    a ring slot), fewer streams than one CTA's slots (1, 5: a ragged last
    slot at 129 bins), and 40,000 streams (many ring slots a CTA)."""
    spec = batched.SketchSpec(0.01, n_bins=n_bins)
    st = _state(spec, n, 5, dev, mixed)
    if n == 1:  # _state empties stream 0: keep the one stream live
        st.count = st.bins_pos.sum(1) + st.bins_neg.sum(1) + st.zero_count
    qs = torch.linspace(-0.1, 1.1, n_q, device=dev) if n_q > 1 else torch.tensor([0.5], device=dev)
    _quantile_matches_plain(spec, st, qs)


@pytest.mark.parametrize("n_bins", [512, 2048, 300, 129])
@pytest.mark.parametrize("n_q", [4, len(EDGE_QS)])
def test_quantile_kernel_edge_rows(dev, n_bins, n_q):
    """Hand-built rows: empty, zero-only, one-sign streams, all mass in bin
    0 or bin n_bins - 1, count 0 over mass, integer running sums up to
    2**24 (the f32 exactness ceiling) and ranks landing on running sums."""
    spec = batched.SketchSpec(0.01, n_bins=n_bins)
    st = convert.state_from_numpy(spec, edge_leaves(n_bins, 263), device=dev)
    _quantile_matches_plain(spec, st, torch.tensor(EDGE_QS[:n_q], device=dev))


@pytest.mark.parametrize("n_bins", [15000, 4001])
def test_quantile_kernel_wide_rows(dev, n_bins):
    """Rows too wide for four consumer warps' ring slots in shared memory
    (15,000 bins; 4,001 bins at four streams a slot) take the kernel's
    device-memory path."""
    spec = batched.SketchSpec(0.01, n_bins=n_bins)
    _quantile_matches_plain(spec, _state(spec, 300, 12, dev, True),
                            torch.tensor([0.0, 0.5, 0.99, 1.0, 1.1], device=dev))
    st = convert.state_from_numpy(spec, edge_leaves(n_bins, 24), device=dev)
    _quantile_matches_plain(spec, st, torch.tensor(EDGE_QS, device=dev))


def test_quantile_kernel_rejects_misaligned_bins(dev):
    """The ring's bulk copies need 16-byte aligned stores: a view that
    starts 4 bytes in raises before any launch."""
    spec = batched.SketchSpec(0.01, n_bins=512)
    st = _state(spec, 64, 13, dev, True)
    flat = torch.zeros(64 * 512 + 1, device=dev)
    flat[1:] = st.bins_pos.reshape(-1)
    st.bins_pos = flat[1:].view(64, 512)
    assert st.bins_pos.is_contiguous() and st.bins_pos.data_ptr() % 16 == 4
    before = kernels.fused_quantile.launches
    with pytest.raises(SketchValueError):
        kernels.fused_quantile(spec, st, [0.5])
    assert kernels.fused_quantile.launches == before


def _overlap_equals_tiles(spec, st, qs, everywhere=False, **kw):
    """The overlap kernel against its plain version (rtol 1e-6) and against
    the tile kernel bit for bit on every rank its lists serve, and on every
    rank when ``everywhere`` (lists that hold each block's whole union);
    returns the mask of ranks served or needing no tile (zero bucket, NaN)."""
    before = kernels.fused_quantile_tiles_overlap.launches
    got = kernels.fused_quantile_tiles_overlap(spec, st, qs, **kw)
    assert kernels.fused_quantile_tiles_overlap.launches == before + 1
    cpu = st.map(lambda t: t.cpu())
    ref = kernels.fused_quantile_tiles_overlap(spec, cpu, qs.cpu(), **kw)
    assert _rel_ok(got, ref, 1e-6)
    # Served: the rank's crossing tile is an entry of its block's list (the
    # plain version's rule); the others fold a zero tile by contract.
    q, t = qs.numel(), spec.n_tiles
    bn = kw.get("block_streams") or kernels._stream_block(st.n_streams)
    lp, ln, packed = kernels._tile_query_operands(spec, st, qs, bn, kw["k_tiles"])
    ut = packed[:, q: 2 * q].long()
    blk = torch.arange(st.n_streams, device=st.bins_pos.device) // bn
    neg = ut >= t
    served = torch.where(
        neg,
        (ln[blk].long()[:, None, :] == (ut - t)[:, :, None]).any(-1),
        (lp[blk].long()[:, None, :] == ut[:, :, None]).any(-1),
    )
    if not kw.get("with_neg", True):
        served &= ~neg
    tiles = kernels.fused_quantile_tiles(spec, st, qs, k_tiles=kw["k_tiles"],
                                         with_neg=kw.get("with_neg", True))
    assert torch.equal(torch.isnan(got), torch.isnan(tiles))
    assert torch.equal(got[served].nan_to_num(), tiles[served].nan_to_num())
    if everywhere:
        assert torch.equal(got.nan_to_num(), tiles.nan_to_num())
    live = (packed[:, 2 * q: 3 * q] < 0.5) & (packed[:, 3 * q: 4 * q] < 0.5)
    return served | ~live  # zero-bucket and NaN ranks need no tile


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("lookahead", [1, 2, 4, 8])
@pytest.mark.parametrize("block_streams", [0, 256])
def test_overlap_kernel_vs_plain(dev, mixed, lookahead, block_streams):
    spec = batched.SketchSpec(0.01, n_bins=1024)
    st = _state(spec, 1024, 6, dev, mixed)
    qs = torch.tensor([0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0, -0.1], device=dev)
    k_tiles, with_neg = kernels.plan_tile_query(spec, st, qs)
    for wn in {with_neg, True}:
        for k in {k_tiles, spec.n_tiles}:
            served = _overlap_equals_tiles(spec, st, qs, everywhere=True, k_tiles=k,
                                           with_neg=wn, block_streams=block_streams,
                                           lookahead=lookahead)
            assert bool(served.all())  # the lists serve every rank that needs a tile


def test_overlap_kernel_honours_short_lists(dev):
    """With k_tiles below a block's needed-tile union, ranks whose tile is
    not listed fold a zero tile -- the TPU kernel's contract, which the
    plain version repeats; the ranks the lists do serve equal the tile
    kernel."""
    spec = batched.SketchSpec(0.01, n_bins=1024)
    st = _state(spec, 512, 7, dev, True)
    qs = torch.tensor([0.1, 0.5, 0.9, 0.99], device=dev)
    for k_tiles, lookahead in ((1, 2), (2, 8), (3, 4)):
        served = _overlap_equals_tiles(spec, st, qs, k_tiles=k_tiles, lookahead=lookahead)
        if k_tiles == 1:
            assert not bool(served.all())  # some ranks go unserved


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("lookahead", [1, 4, 8])
def test_overlap_kernel_wraps_sub_blocks(dev, mixed, lookahead):
    """16,384 streams: more sub-blocks than resident CTAs, so each CTA's
    ring runs across several sub-blocks and plan blocks (slot and phase
    from the running step counter)."""
    spec = batched.SketchSpec(0.01, n_bins=512)
    st = _state(spec, 16384, 10, dev, mixed)
    qs = torch.tensor([0.5, 0.9, 0.99, 0.999], device=dev)
    k_tiles, with_neg = kernels.plan_tile_query(spec, st, qs)
    served = _overlap_equals_tiles(spec, st, qs, everywhere=True, k_tiles=k_tiles,
                                   with_neg=with_neg, lookahead=lookahead)
    assert bool(served.all())


@pytest.mark.parametrize("block_streams", [200, 40, 8])
@pytest.mark.parametrize("lookahead", [2, 8])
def test_overlap_kernel_ragged_block(dev, block_streams, lookahead):
    """block_streams not a multiple of the 16 rows a sub-block takes: the
    last sub-block of every plan block is part empty."""
    spec = batched.SketchSpec(0.01, n_bins=1024)
    st = _state(spec, 1000, 11, dev, True)
    qs = torch.tensor([0.0, 0.25, 0.5, 0.9, 0.99, 1.0, -0.1], device=dev)
    for k in (spec.n_tiles, 2):
        _overlap_equals_tiles(spec, st, qs, k_tiles=k, block_streams=block_streams,
                              lookahead=lookahead)


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


def _pinned_facade(n, seed, device, negate=0.4):
    """A facade with every stream on one pinned window (no auto-centring),
    two mixed-sign batches through the kernels."""
    sk = batched.BatchedDDSketch(n, relative_accuracy=0.01, n_bins=512, key_offset=-200,
                                 device=device)
    r = np.random.RandomState(seed)
    for _ in range(2):
        v = r.lognormal(0, 2, (n, 256)) * np.where(r.rand(n, 256) < negate, -1, 1)
        sk.add(v.astype(np.float32))
    return sk


def test_wire_round_trip_on_the_card(dev):
    """16,384 pinned streams: encode -> decode onto the card -> encode gives
    the same bytes, the decoded state equals the original on every leaf the
    wire carries (sum, min, max and the collapse counters are not on it)
    and the default route answers through the overlap kernel bit for
    bit."""
    from sketches_tpu_torch.pb import wire

    sk = _pinned_facade(16384, 11, dev)
    blobs = wire.state_to_bytes(sk.spec, sk.state)
    back = wire.bytes_to_state(sk.spec, blobs, device=dev)
    assert back.device == sk.state.device
    assert wire.state_to_bytes(sk.spec, back) == blobs
    off_wire = ("sum", "min", "max", "collapsed_low", "collapsed_high")
    for f in batched.LEAVES:
        if f not in off_wire:
            assert torch.equal(getattr(back, f), getattr(sk.state, f)), f
    dec = batched.BatchedDDSketch(16384, spec=sk.spec, state=back)
    qs = [0.5, 0.9, 0.99, 0.999]
    kernels.reset_launch_counts()
    tier_a, a = sk.get_quantile_values_resolved(qs)
    tier_b, b = dec.get_quantile_values_resolved(qs)
    assert tier_a == tier_b == "overlap"
    assert kernels.launch_counts()["fused_quantile_tiles_overlap"] == 2
    assert torch.equal(a.nan_to_num(), b.nan_to_num())


def test_checkpoint_restores_onto_the_card(dev, tmp_path):
    from sketches_tpu_torch import checkpoint

    sk = _pinned_facade(4096, 12, dev)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, sk)
    back = checkpoint.restore(path)  # the card by default
    assert back.device.type == "cuda" and back.engine == "kernel"
    for f in batched.LEAVES:
        assert torch.equal(getattr(back.state, f), getattr(sk.state, f)), f
    qs = [0.5, 0.99]
    assert torch.equal(back.get_quantile_values(qs), sk.get_quantile_values(qs))
    _, cpu_state = checkpoint.restore_state(path, device="cpu")
    assert torch.equal(cpu_state.bins_neg, sk.state.bins_neg.cpu())


@pytest.mark.parametrize("native_tier", [True, False], ids=["native", "device"])
def test_torch_ddsketch_on_the_card_equals_cpu(dev, native_tier, monkeypatch):
    """The single-sketch facade on the card against the same facade on the
    CPU: the same plain batched functions on the same f32 values, so every
    leaf but ``sum`` is equal and quantiles agree to rtol 1e-6.  Values sit
    mid-bucket: the card's and the CPU's f32 ``log`` may round a value
    within an ulp of a bucket edge to neighbouring keys."""
    from sketches_tpu_torch import ddsketch, native

    if not native_tier:
        monkeypatch.setenv(native.NATIVE_ENV, "0")
    native.reset()
    try:
        r = np.random.RandomState(13)
        v = r.lognormal(0, 2, 100_000) * np.where(r.rand(100_000) < 0.4, -1, 1)
        gamma = 1.01 / 0.99
        v = np.sign(v) * gamma ** (np.ceil(np.log(np.abs(v)) / np.log(gamma)) - 0.5)
        v = v.astype(np.float32).astype(np.float64)
        sks = [ddsketch.DDSketch(0.01, backend="torch", device=d) for d in (dev, "cpu")]
        for sk in sks:
            assert sk.flush_tier == ("native" if native_tier else "device")
            sk.add_many(v[:90_000])
            for x in v[90_000:].tolist():
                sk.add(x)
        card, cpu = sks
        assert (card.count, card.sum, card.zero_count) == (cpu.count, cpu.sum, cpu.zero_count)
        card._settle()
        cpu._settle()
        for f in batched.LEAVES:
            a, b = getattr(card._state, f).cpu(), getattr(cpu._state, f)
            if f == "sum":
                assert torch.allclose(a, b, rtol=1e-5)
            else:
                assert torch.equal(a, b), f
        for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert card.get_quantile_value(q) == pytest.approx(cpu.get_quantile_value(q),
                                                                rel=1e-6)
    finally:
        monkeypatch.delenv(native.NATIVE_ENV, raising=False)
        native.reset()


def test_pair_sum_collapse_on_the_card_equals_the_cpu(dev):
    """The uniform collapse (a pair sum, no atomics) on random integer-valued
    states, then an adaptive facade driven through the guard, the trigger
    and a merge: the card's levels and every leaf equal the CPU's (``sum``
    to rtol 1e-5: f32 sums in another order; ``min``/``max`` to rtol 1e-6:
    they track the premapped representatives, whose decode ``exp`` may
    differ by an ulp between the card and the CPU)."""
    from sketches_tpu_torch.backends import uniform

    spec = batched.SketchSpec(0.01, n_bins=512, backend="uniform_collapse",
                              collapse_threshold=0.05)
    r = np.random.RandomState(21)
    n = 4096
    bins = np.where(r.rand(2, n, 512) < 0.3, r.randint(1, 50, (2, n, 512)), 0).astype(np.float32)
    cpu = uniform.init(spec, n, "cpu")
    for i, name in enumerate(("bins_pos", "bins_neg")):
        setattr(cpu.base, name, torch.from_numpy(bins[i]))
    cpu.base.key_offset = torch.from_numpy(r.randint(-600, 200, n).astype(np.int32))
    cpu.level = torch.from_numpy(r.randint(0, 4, n).astype(np.int32))
    card = uniform.AdaptiveState(cpu.base.map(lambda t: t.to(dev)), cpu.level.to(dev))
    mask = torch.from_numpy(r.rand(n) < 0.7)
    target = torch.from_numpy(r.randint(0, 6, n).astype(np.int32))
    for a, b in ((uniform.collapse_once(spec, card, mask.to(dev)),
                  uniform.collapse_once(spec, cpu, mask)),
                 (uniform.collapse_to(spec, card, target.to(dev)),
                  uniform.collapse_to(spec, cpu, target))):
        assert torch.equal(a.level.cpu(), b.level)
        for f in batched.LEAVES:
            assert torch.equal(getattr(a.base, f).cpu(), getattr(b.base, f)), f
    facades = [uniform.AdaptiveDDSketch(n, relative_accuracy=0.01, n_bins=512, device=d)
               for d in (dev, "cpu")]
    others = [uniform.AdaptiveDDSketch(n, relative_accuracy=0.01, n_bins=512, device=d)
              for d in (dev, "cpu")]
    for sigma in (1.0, 6.0, 2.0):
        v = r.lognormal(0, sigma, (n, 256)).astype(np.float32)
        for sk in facades:
            sk.add(v)
    w = r.lognormal(3, 1, (n, 256)).astype(np.float32)
    for sk, o in zip(facades, others):
        o.add(w)
        sk.merge(o)
    card_sk, cpu_sk = facades
    assert card_sk.engine == "kernel" and int(cpu_sk.level.max()) >= 2
    assert torch.equal(card_sk.level.cpu(), cpu_sk.level)
    for f in batched.LEAVES:
        a, b = getattr(card_sk.state.base, f).cpu(), getattr(cpu_sk.state.base, f)
        if f == "sum":
            assert torch.allclose(a, b, rtol=1e-5)
        elif f in ("min", "max"):
            assert torch.allclose(a, b, rtol=1e-6, atol=0), f
        else:
            assert torch.equal(a, b), f
    qs = [0.5, 0.9, 0.99, 0.999]
    assert _rel_ok(card_sk.get_quantile_values(qs), cpu_sk.get_quantile_values(qs), 1e-6)


def test_weighted_rank_boundary_kernels_equal_their_plain_versions(dev):
    """One stream at alpha 0.02 whose third weighted prefix sum equals
    ``count - 1`` exactly (queue C of the ROADMAP), tiled over 256 streams:
    K2, K3, K4 and K5 each against its plain version on the card, and the
    answer at q = 1 is the JAX package's 2.6642716."""
    n = 256
    sk = batched.BatchedDDSketch(n, relative_accuracy=0.02, n_bins=256, device=dev)
    v1 = np.tile(np.asarray([0.43233886, 0.20904201], np.float32), (n, 1))
    w1 = np.tile(np.asarray([1.0375978, 0.97834975], np.float32), (n, 1))
    sk.add(v1, w1).add(np.tile(np.asarray([2.7012644, 0.36471483], np.float32), (n, 1)))
    spec, st = sk.spec, sk.state
    qs = torch.tensor([1.0, 0.5, 0.0], device=dev)
    lo_w, n_w, w_t, with_neg = kernels.plan_state_window(spec, st)
    k_tiles, with_neg_t = kernels.plan_tile_query(spec, st, qs)
    bn = kernels._stream_block(n)
    lists_pos, lists_neg, packed_o = kernels._tile_query_operands(spec, st, qs, bn, k_tiles)
    pairs = {
        "fused_quantile": (kernels.fused_quantile(spec, st, qs),
                           kernels.fused_quantile_plain(spec, st, qs)),
        "windowed": (kernels.fused_quantile_windowed(spec, st, qs, lo_w, n_wblocks=n_w,
                                                     w_tiles=w_t, with_neg=with_neg),
                     torch.where(kernels._valid(st, qs), kernels.fused_quantile_windowed_plain(
                         spec, st, kernels._windowed_packed(st, qs), lo_w * w_t * 128,
                         n_w * w_t, with_neg, qs.numel()), float("nan"))),
        "tiles": (kernels.fused_quantile_tiles(spec, st, qs, k_tiles=k_tiles, with_neg=with_neg_t),
                  kernels.fused_quantile_tiles_plain(spec, st, kernels._tiles_packed(spec, st, qs),
                                                     with_neg_t, qs.numel())),
        "overlap": (kernels.fused_quantile_tiles_overlap(spec, st, qs, k_tiles=k_tiles,
                                                         with_neg=with_neg_t),
                    kernels.fused_quantile_tiles_overlap_plain(
                        spec, st, lists_pos, lists_neg, packed_o, bn, with_neg_t, qs.numel())),
    }
    for name, (got, ref) in pairs.items():
        assert torch.equal(got, ref), name
        assert got[0, 0].item() == np.float32(2.6642716), name


def _mixed_facades(dev, n=1024, seed=31):
    r = np.random.RandomState(seed)
    sk = batched.BatchedDDSketch(n, relative_accuracy=0.01, n_bins=512, device=dev)
    plain = batched.BatchedDDSketch(n, relative_accuracy=0.01, n_bins=512, device=dev,
                                    engine="plain")
    for _ in range(3):
        v = (r.lognormal(0, 2, (n, 256)) * np.where(r.rand(n, 256) < 0.4, -1, 1)).astype(np.float32)
        sk.add(v)
        plain.add(v)
    return sk, plain


def test_ladder_walk_on_the_card_is_bit_equal_to_plain(dev, armed):
    """``pallas.lowering`` armed once for each kernel tier in turn: the facade
    answers on the next tier each time, bit for bit the plain facade's
    answer, and the ledger holds the four ``batched.query`` steps."""
    from sketches_tpu_torch import faults, parallel, resilience

    qs = [0.5, 0.9, 0.99, 0.999]
    sk, plain = _mixed_facades(dev)
    want = plain.get_quantile_values(qs)
    kernels.reset_launch_counts()
    tiers = []
    try:
        for tier in ("overlap", "tiles", "windowed", "wxla"):
            faults.arm(faults.PALLAS_LOWERING, tier=tier, times=1)
            got_tier, got = sk.get_quantile_values_resolved(qs)
            faults.disarm()
            tiers.append(got_tier)
            assert torch.equal(got, want), got_tier
        assert tiers == ["tiles", "windowed", "wxla", "xla"]
        assert [(e["component"], e["from_tier"], e["to_tier"])
                for e in resilience.health()["downgrades"]] == [
            ("batched.query", "overlap", "tiles"), ("batched.query", "tiles", "windowed"),
            ("batched.query", "windowed", "wxla"), ("batched.query", "wxla", "xla")]
        counts = kernels.launch_counts()
        assert counts["fused_quantile_tiles"] == counts["fused_quantile_windowed"] == 1
        assert counts["fused_quantile_tiles_overlap"] == 0  # injected before its launch
        # The distributed facade down to its floor, K2.
        resilience.reset()
        mesh = parallel.SketchMesh(devices=[dev, dev])
        r = np.random.RandomState(32)
        dist = parallel.DistributedDDSketch(1024, mesh=mesh, relative_accuracy=0.01, n_bins=512)
        ref = parallel.DistributedDDSketch(1024, mesh=mesh, relative_accuracy=0.01, n_bins=512,
                                           engine="plain")
        for _ in range(2):
            v = (r.lognormal(0, 2, (1024, 256))
                 * np.where(r.rand(1024, 256) < 0.4, -1, 1)).astype(np.float32)
            dist.add(v)
            ref.add(v)
        faults.arm(faults.PALLAS_LOWERING, tier=("overlap", "tiles", "windowed", "wxla"))
        kernels.reset_launch_counts()
        tier, got = dist.get_quantile_values_resolved(qs)
        faults.disarm()
        assert tier == "xla" and kernels.launch_counts()["fused_quantile"] == 1
        assert torch.equal(got, ref.get_quantile_values(qs))
        assert len(resilience.health()["downgrades"]) == 4
    finally:
        faults.disarm()
        resilience.reset()


def test_ingest_demotion_on_the_card_replays_exactly(dev, armed):
    from sketches_tpu_torch import faults, resilience

    r = np.random.RandomState(33)
    n = 1024
    sk = batched.BatchedDDSketch(n, relative_accuracy=0.01, n_bins=512, device=dev)
    plain = batched.BatchedDDSketch(n, relative_accuracy=0.01, n_bins=512, device=dev,
                                    engine="plain")
    vs = [r.lognormal(0, 2, (n, 256)).astype(np.float32) for _ in range(2)]
    for s in (sk, plain):
        s.add(vs[0])
    try:
        faults.arm(faults.PALLAS_INGEST, times=1)
        sk.add(vs[1])
        faults.disarm()
        plain.add(vs[1])
        assert [e["to_tier"] for e in resilience.health()["downgrades"]] == ["plain"]
    finally:
        faults.disarm()
        resilience.reset()
    for f in batched.LEAVES:
        a, b = getattr(sk.state, f), getattr(plain.state, f)
        if f == "sum":
            assert torch.allclose(a, b, rtol=1e-5)
        else:
            assert torch.equal(a, b), f


def test_ingest_variant_demotion_on_the_card_stays_on_k1(dev, armed):
    """An armed ``pallas.ingest_variant`` fault demotes the rung to
    ``stock`` (not the facade to the plain path): K1 keeps launching and
    the batch lands exactly as on a plain facade."""
    from sketches_tpu_torch import faults, resilience

    r = np.random.RandomState(34)
    n = 1024
    sk = batched.BatchedDDSketch(n, relative_accuracy=0.01, n_bins=512, device=dev,
                                 engine="kernel")
    plain = batched.BatchedDDSketch(n, relative_accuracy=0.01, n_bins=512, device=dev,
                                    engine="plain")
    vs = [r.lognormal(0, 2, (n, 256)).astype(np.float32) for _ in range(2)]
    for s in (sk, plain):
        s.add(vs[0])
    kernels.reset_launch_counts()
    try:
        faults.arm(faults.PALLAS_INGEST_VARIANT, times=1)
        sk.add(vs[1])
        faults.disarm()
        plain.add(vs[1])
        assert [(e["component"], e["from_tier"], e["to_tier"])
                for e in resilience.health()["downgrades"]] == [
            ("batched.ingest_variant", "packed", "stock")]
    finally:
        faults.disarm()
        resilience.reset()
    assert sk._kernel_ingest and kernels.launch_counts()["ingest_histogram"] > 0
    for f in batched.LEAVES:
        a, b = getattr(sk.state, f), getattr(plain.state, f)
        if f == "sum":
            assert torch.allclose(a, b, rtol=1e-5)
        else:
            assert torch.equal(a, b), f


def test_chaos_core_campaign_on_the_card_equals_the_cpu_run(dev, armed):
    from sketches_tpu_torch import chaos

    kernels.reset_launch_counts()
    card = chaos.run_campaign(80, 3, device=dev)
    launches = kernels.launch_counts()
    cpu = chaos.run_campaign(80, 3, device="cpu")
    assert card["ok"], card["errors"]
    assert [(e["step"], e["site"], e["outcome"]) for e in card["events"]] == [
        (e["step"], e["site"], e["outcome"]) for e in cpu["events"]]
    assert card["final_count"] == cpu["final_count"] == card["expected_count"]
    assert launches["ingest_histogram"] > 0 and launches["fused_quantile"] > 0


def test_state_bitflips_on_the_card_equal_the_cpu(dev, armed):
    from sketches_tpu_torch import faults

    sk, _ = _mixed_facades(dev, n=256, seed=34)
    faults.arm(faults.STATE_BITFLIP, seed=5)
    try:
        flips = [faults.state_bitflips(256, 512)[0] for _ in range(12)] + [(0, 1, 2, 31)]
    finally:
        faults.disarm()
    card = faults.apply_state_bitflips(sk.state, flips)
    cpu = faults.apply_state_bitflips(sk.state.map(lambda t: t.cpu()), flips)
    assert card.device == sk.state.device
    for f in ("bins_pos", "bins_neg"):
        assert torch.equal(getattr(card, f).cpu().view(torch.int32),
                           getattr(cpu, f).view(torch.int32)), f
        assert not torch.equal(getattr(card, f), getattr(sk.state, f)), f


def test_kernel_errors_on_the_card_raise_and_never_demote(dev, monkeypatch):
    """A real kernel failure on CUDA tensors (no fault armed) raises out of
    both facades: neither steps down to a plain tier, and the ledger stays
    empty (checked by ``_no_downgrade_unless_armed``)."""
    from sketches_tpu_torch import parallel

    def broken(*a, **k):
        raise RuntimeError("launch failed")

    qs = [0.5, 0.99]
    sk, _ = _mixed_facades(dev, n=1024, seed=35)
    mesh = parallel.SketchMesh(devices=[dev, dev])
    dist = parallel.DistributedDDSketch(1024, mesh=mesh, relative_accuracy=0.01, n_bins=512)
    r = np.random.RandomState(36)
    dist.add((r.lognormal(0, 2, (1024, 256))
              * np.where(r.rand(1024, 256) < 0.4, -1, 1)).astype(np.float32))
    # Both facades answer on a kernel tier while the kernels work.
    for facade in (sk, dist):
        assert facade.get_quantile_values_resolved(qs)[0] in ("overlap", "tiles", "windowed")
    for name in ("fused_quantile_tiles_overlap", "fused_quantile_tiles",
                 "fused_quantile_windowed", "fused_quantile", "add"):
        monkeypatch.setattr(kernels, name, broken)
    for facade in (sk, dist):
        with pytest.raises(RuntimeError, match="launch failed"):
            facade.get_quantile_values(qs)
        assert facade._query_disabled == set()
    with pytest.raises(RuntimeError, match="launch failed"):
        sk.add(np.ones((1024, 256), np.float32))
    assert sk._kernel_ingest


def test_armed_profiling_synchronizes_and_disarmed_never_does(dev, monkeypatch):
    """Armed, each facade dispatch waits for its output on the card (the
    host clock across ``torch.cuda.synchronize``); disarmed, no seam
    synchronizes at all."""
    from sketches_tpu_torch import profiling

    waits = []
    real = torch.cuda.synchronize

    def spy(device=None):
        waits.append(torch.device(device))
        return real(device)

    monkeypatch.setattr(torch.cuda, "synchronize", spy)
    sk, _ = _mixed_facades(dev, n=1024, seed=37)
    v = np.random.RandomState(38).lognormal(0, 2, (1024, 256)).astype(np.float32)
    sk.add(v)
    sk.get_quantile_values([0.5, 0.99])
    assert waits == []
    profiling.enable()
    try:
        sk.add(v)
        sk.get_quantile_values([0.5, 0.99])
        measured = profiling.attribution()["measured"]
    finally:
        profiling.disable()
        profiling.reset()
    assert waits == [dev, dev]
    assert measured["ingest/kernel"]["calls"] == 1
    assert measured["query/overlap"]["calls"] == 1 and measured["query/overlap"]["total_s"] > 0


def test_kernel_errors_inside_armed_observability_raise(dev, monkeypatch):
    """A failure the card reports inside an armed profiling seam, or a kernel
    error inside an accuracy audit's query, raises out of the call: it is
    never audited as absent and no tier steps down."""
    from sketches_tpu_torch import accuracy, profiling

    sk, _ = _mixed_facades(dev, n=1024, seed=39)
    v = np.random.RandomState(40).lognormal(0, 2, (1024, 256)).astype(np.float32)

    def broken_wait(device=None):
        raise RuntimeError("device-side assert")

    profiling.enable()
    try:
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", broken_wait)
            with pytest.raises(RuntimeError, match="device-side assert"):
                sk.get_quantile_values([0.5, 0.99])
            with pytest.raises(RuntimeError, match="device-side assert"):
                sk.add(v)
    finally:
        profiling.disable()
        profiling.reset()
    assert sk._query_disabled == set() and sk._kernel_ingest

    def broken(*a, **k):
        raise RuntimeError("launch failed")

    accuracy.enable()
    try:
        accuracy.watch(sk, "card", streams=(0, 1), interval=1)
        monkeypatch.setattr(kernels, "fused_quantile_tiles_overlap", broken)
        with pytest.raises(RuntimeError, match="launch failed"):
            sk.add(v)
        assert accuracy.summary()["audits"] == 0
    finally:
        accuracy.disable()
        accuracy.reset()
    assert sk._query_disabled == set()


def _card_server(dev, names=("a", "b"), n=1024, seed=41, sizes=None, clock=None, **cfg):
    """A server with dense tenants of one spec on the card (512 bins, mixed
    traffic), on a fixed serving clock unless ``clock`` is given;
    ``sizes`` gives each tenant its own stream count."""
    from sketches_tpu_torch import serve

    srv = serve.SketchServer(serve.ServeConfig(**cfg), clock=clock or (lambda: 0.0))
    r = np.random.RandomState(seed)
    for name, n in zip(names, sizes or [n] * len(names)):
        srv.add_tenant(name, n, relative_accuracy=0.01, n_bins=512, device=dev)
        srv.ingest(name, (r.lognormal(0, 2, (n, 256))
                          * np.where(r.rand(n, 256) < 0.4, -1, 1)).astype(np.float32))
    return srv


def test_stacked_flush_launches_k2_once_per_group(dev):
    """Tenants sharing a spec and a quantile set answer in one K2 launch,
    equal to each tenant's plain ``batched.quantile`` on the card bit for
    bit, and to the CPU copy's to rtol 1e-6 (the decode's exp)."""
    qs = [0.01, 0.5, 0.99]
    srv = _card_server(dev, names=("a", "b", "c"))
    tickets = [srv.submit(name, qs) for name in ("a", "b", "c")]
    kernels.reset_launch_counts()
    srv.flush()
    counts = kernels.launch_counts()
    assert counts["fused_quantile"] == 1 and srv.stats()["fused_dispatches"] == 1
    assert sum(counts.values()) == 1
    for tk in tickets:
        spec, st = srv.tenant(tk.tenant).spec, srv.tenant(tk.tenant).state
        assert tk.result.tier == "xla" and not tk.result.hedged
        want = batched.quantile(spec, st, qs).cpu()
        assert torch.equal(torch.from_numpy(tk.result.values), want)
        cpu = batched.quantile(spec, st.map(lambda t: t.cpu()), qs)
        assert _rel_ok(torch.from_numpy(tk.result.values), cpu, 1e-6)


def _plain_calls_on_card(monkeypatch) -> list:
    """Spy on ``batched.quantile``: the returned list gains one entry per
    call on a card state."""
    calls = []
    real = batched.quantile

    def spy(spec, state, qs):
        if state.device.type == "cuda":
            calls.append(state.n_streams)
        return real(spec, state, qs)

    monkeypatch.setattr(batched, "quantile", spy)
    return calls


def test_stacked_flush_of_mixed_stream_counts_is_one_k2_launch(dev, monkeypatch):
    """Tenants of one spec whose stream counts are no multiple of the
    kernels' block still stack into one K2 launch: no plain
    ``batched.quantile`` on the card, answers equal to it bit for bit."""
    qs = [0.01, 0.5, 0.99]
    names = ("a", "b", "c")
    srv = _card_server(dev, names=names, sizes=(1000, 1024, 77))
    tickets = [srv.submit(name, qs) for name in names]
    plain = _plain_calls_on_card(monkeypatch)
    kernels.reset_launch_counts()
    srv.flush()
    counts = kernels.launch_counts()
    assert counts["fused_quantile"] == 1 and sum(counts.values()) == 1 and plain == []
    assert srv.stats()["fused_dispatches"] == 1
    monkeypatch.undo()
    for tk in tickets:
        f = srv.tenant(tk.tenant)
        assert tk.result.tier == "xla"
        assert torch.equal(torch.from_numpy(tk.result.values),
                           batched.quantile(f.spec, f.state, qs).cpu())


def test_serve_floor_and_hedge_launch_k2(dev, monkeypatch):
    """A single tenant's flush inside the floor margin, and the hedge of a
    primary that straggled past ``hedge_after_s``, answer on the ``xla``
    floor with K2 and run no plain ``batched.quantile`` on the card; both
    equal it bit for bit."""
    qs = (0.5, 0.99)
    srv = _card_server(dev, names=("a",), n=1000, floor_margin_s=0.02)
    want = batched.quantile(srv.tenant("a").spec, srv.tenant("a").state, qs).cpu().numpy()
    plain = _plain_calls_on_card(monkeypatch)
    kernels.reset_launch_counts()
    tk = srv.submit("a", qs, deadline_s=0.01)
    srv.flush()
    assert tk.result.tier == "xla" and not tk.result.hedged
    assert kernels.launch_counts()["fused_quantile"] == 1 and plain == []
    assert np.array_equal(tk.result.values, want)
    # A serving clock that moves 0.1 s a read: every primary straggles.
    ticks = iter(range(1 << 20))
    srv = _card_server(dev, names=("b",), clock=lambda: 0.1 * next(ticks),
                       default_deadline_s=1e6, cache_capacity=0)
    kernels.reset_launch_counts()
    res = srv.query("b", qs)
    counts = kernels.launch_counts()
    assert res.hedged and res.tier == "overlap" and srv.stats()["hedges"] == 1
    assert counts["fused_quantile_tiles_overlap"] == 1 and counts["fused_quantile"] == 1
    assert plain == []
    monkeypatch.undo()
    f = srv.tenant("b")
    assert np.array_equal(res.values, batched.quantile(f.spec, f.state, qs).cpu().numpy())


def test_repeat_window_query_launches_the_ladder_kernel(dev, monkeypatch):
    """A window query folds the maintained components and decodes the fold
    through a throwaway facade's ladder (K5 on this traffic); a repeat on
    the unchanged window decodes the cached fold again through K5, with no
    K2 and no new fold; both equal ``oracle_quantile``, which decodes with
    the plain ``batched.quantile`` and launches nothing.  The full re-merge
    lane (``SKETCHES_TPU_WINDOW_AGG=0``) decodes with one K2."""
    from sketches_tpu_torch import windows

    qs = [0.01, 0.5, 0.99]

    def ring():
        clk = windows.VirtualClock(0.0)
        w = windows.WindowedSketch(1024, relative_accuracy=0.01, n_bins=512, clock=clk,
                                   config=windows.WindowConfig((5.0, 20.0), (3, 3)), device=dev)
        r = np.random.RandomState(42)
        for _ in range(12):
            clk.advance(2.5)
            w.add((r.lognormal(0, 2, (1024, 256))
                   * np.where(r.rand(1024, 256) < 0.4, -1, 1)).astype(np.float32))
        return w

    w = ring()
    kernels.reset_launch_counts()
    first = w.quantile(qs, window=None)
    counts = kernels.launch_counts()
    assert counts["fused_quantile_tiles_overlap"] == 1 and counts["fused_quantile"] == 0
    merges = w.agg_stats()["query_merges"]
    kernels.reset_launch_counts()
    again = w.quantile(qs, window=None)
    counts = kernels.launch_counts()
    assert counts["fused_quantile_tiles_overlap"] == 1 and counts["fused_quantile"] == 0
    assert w.agg_stats()["query_merges"] == merges
    kernels.reset_launch_counts()
    oracle = windows.oracle_quantile(w, qs, window=None)
    assert sum(kernels.launch_counts().values()) == 0
    assert torch.equal(first, oracle) and torch.equal(again, oracle)
    monkeypatch.setenv("SKETCHES_TPU_WINDOW_AGG", "0")
    full = ring()
    kernels.reset_launch_counts()
    got = full.quantile(qs, window=None)
    assert kernels.launch_counts()["fused_quantile"] == 1
    assert torch.equal(got, windows.oracle_quantile(full, qs, window=None))


def test_kernel_error_inside_serve_flush_raises(dev, monkeypatch):
    """A kernel error in the stacked flush or in a tenant's own dispatch
    raises out of the server: no hedge onto a plain path, no downgrade."""
    from sketches_tpu_torch.resilience import EngineUnavailable

    def broken(*a, **k):
        raise EngineUnavailable("sk_quantile launch failed with CUDA error 700")

    srv = _card_server(dev)
    monkeypatch.setattr(kernels, "fused_quantile", broken)
    for name in ("a", "b"):
        srv.submit(name, [0.5])
    with pytest.raises(EngineUnavailable, match="launch failed"):
        srv.flush()
    for name in ("fused_quantile_tiles_overlap", "fused_quantile_tiles", "fused_quantile_windowed"):
        monkeypatch.setattr(kernels, name, broken)
    with pytest.raises(EngineUnavailable, match="launch failed"):
        srv.query("a", [0.9])
    assert srv.stats()["hedges"] == 0 and srv.tenant("a")._query_disabled == set()


# ---------------------------------------------------------------------------
# The property suites' draws on the card: K1-K5 against their plain versions
# ---------------------------------------------------------------------------


def _same(a, b) -> bool:
    """Bit for bit, NaN positions included."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        a.nan_to_num().view(torch.int32), b.nan_to_num().view(torch.int32))


@steady(60)
@given(with_mid(WINDOW_STREAMS), SEEDS)
def test_kernels_equal_plain_on_drawn_streams(dev, pair, seed):
    """The draws of ``tests/test_torch_property.py`` (raw and moved to
    mid-bucket), each one stream of a 128-stream block on a drifted or
    centred window: K1 against ``ingest_histogram_plain`` (unit weights bit
    for bit, zero-weight padding to rtol 1e-5), then K2-K5 on the ingested
    state against their plain versions bit for bit, and K5 equal to K4."""
    for values in pair:
        vals32 = finite_f32(values)
        if len(vals32) == 0:
            continue
        spec = batched.SketchSpec(0.02, n_bins=512)
        padded, w = padded_block(vals32)
        v, w = torch.from_numpy(padded).to(dev), torch.from_numpy(w).to(dev)
        st = batched.init(spec, 128, dev)
        st = batched.recenter(spec, st, batched.auto_offset(spec, st, v, w))
        rng = np.random.RandomState(seed)
        st = batched.recenter(spec, st, st.key_offset + int(rng.randint(-200, 200)))
        _ingest_matches_plain(spec, v, st.key_offset, False)
        _ingest_matches_plain(spec, v, st.key_offset, True, w)
        st = kernels.add(spec, st, v, w)
        qs = torch.tensor([0.0, 0.25, 0.5, 0.9, 1.0], device=dev)
        assert _same(kernels.fused_quantile(spec, st, qs), kernels.fused_quantile_plain(spec, st, qs))
        lo_w, n_w, w_t, with_neg = kernels.plan_state_window(spec, st)
        got = kernels.fused_quantile_windowed(spec, st, qs, lo_w, n_wblocks=n_w, w_tiles=w_t,
                                              with_neg=with_neg)
        ref = kernels.fused_quantile_windowed_plain(
            spec, st, kernels._windowed_packed(st, qs), lo_w * w_t * 128, n_w * w_t, with_neg,
            qs.numel())
        assert _same(got, torch.where(kernels._valid(st, qs), ref, float("nan")))
        k_tiles, with_neg = kernels.plan_tile_query(spec, st, qs)
        tiles = kernels.fused_quantile_tiles(spec, st, qs, k_tiles=k_tiles, with_neg=with_neg)
        packed = kernels._tiles_packed(spec, st, qs)
        assert _same(tiles, kernels.fused_quantile_tiles_plain(spec, st, packed, with_neg,
                                                               qs.numel()))
        over = kernels.fused_quantile_tiles_overlap(spec, st, qs, k_tiles=k_tiles,
                                                    with_neg=with_neg)
        bn = kernels._stream_block(128)
        lists_pos, lists_neg, packed = kernels._tile_query_operands(spec, st, qs, bn, k_tiles)
        assert _same(over, kernels.fused_quantile_tiles_overlap_plain(
            spec, st, lists_pos, lists_neg, packed, bn, with_neg, qs.numel()))
        assert _same(over, tiles)


def test_unarmed_kernel_tests_recorded_no_downgrade(dev):
    """Runs last: no un-armed card test above left a downgrade behind.
    Each was checked on its own as it ran (armed tests clear the ledger,
    so the check cannot wait for the end)."""
    assert _LEAKED == {}
    assert _unexpected_downgrades() == []
