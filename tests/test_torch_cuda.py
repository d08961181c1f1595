"""repro_torch on a CUDA card: each hand-written kernel against its plain
PyTorch version, and the engine on the card against the engine on the
CPU (double-buffered ingest of exact and logmem buckets, finalize_tiers,
launch counters), ``filter_then_merge`` on the card against the CPU.
Every test here is marked ``cuda`` and skips without a card.

The file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Its input-case helpers are shared with the CPU parity tests
(tests/test_torch_kernels.py, tests/test_torch_engine.py,
tests/test_torch_logmem.py, tests/test_torch_topk_filter.py).

Tolerance: exact — integer outputs, and maxima that are input elements.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import costs as t_costs
from repro_torch.core import placement as t_place
from repro_torch.core import simulator as t_sim
from repro_torch.core import topk as t_topk
from repro_torch.kernels.batched_topk import ops as t_btk
from repro_torch.kernels.logmem_update import ops as t_lm_ops
from repro_torch.kernels.tier_assign import ops as t_ta
from repro_torch.kernels.topk_filter import ops as t_tf
from repro_torch.streams import engine as t_eng

METER_FIELDS = ("observed", "writes", "reads", "deletes", "migrations",
                "floor", "occupancy", "occupancy_hwm", "doc_steps",
                "mig_reads", "mig_writes", "boundaries", "migrate")


def btk_case(m, n, seed):
    """Scores with ties and bars of every kind: -inf (unfull reservoir,
    pad columns counted), bars equal to a score, ordinary bars."""
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((m, n)).astype(np.float32)
    scores[:, ::5] = 0.5
    bars = rng.uniform(-1, 1, m).astype(np.float32)
    bars[0] = -np.inf
    if m > 1:
        bars[1] = 0.5
    if m > 2:
        bars[2] = scores[2, n // 2]
    return scores, bars


# widths under one tile (7, 16: pad columns counted arithmetically), one
# full tile (128, 500), and several tiles of 512 with a padded last one
BTK_CASES = [(1, 128), (3, 500), (5, 16), (4, 7), (3, 600), (2, 1024),
             (2, 1300)]


def ta_case(m, k, b, seed):
    """Ids with -1 pads, fractional and ±inf boundaries, cascade floors."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (m, k)).astype(np.int32)
    ids[rng.random((m, k)) < 0.2] = -1
    bounds = np.sort(rng.uniform(0, 1000, (m, b)), axis=1)
    bounds[0, -1] = np.inf
    bounds[-1, 0] = -np.inf
    if b > 1:
        bounds[m // 2, 1:] = bounds[m // 2, :1]  # collapsed middle tiers
    floor = rng.integers(0, b + 1, m).astype(np.int32)
    return ids, bounds, floor


TA_CASES = [(1, 128, 1), (5, 64, 2), (16, 33, 3), (3, 7, 4), (4, 8, 2),
            (2, 5, 7)]


TIED_POOL = np.array([-1.0, -0.0, 0.0, 0.5, 0.5, 1.0, 2.0], np.float32)


def tied_scores(rng, shape):
    """Half the entries from a small pool (ties, both signed zeros), half
    standard normal."""
    return np.where(rng.random(shape) < 0.5,
                    TIED_POOL[rng.integers(0, TIED_POOL.size, shape)],
                    rng.standard_normal(shape)).astype(np.float32)


def lm_admit_case(m, n, seed):
    """Logmem admission inputs: tied scores, pad ids between live ones
    (with finite pad scores), an all-pad row, thresholds of -inf, equal
    to a score, and ordinary."""
    rng = np.random.default_rng(seed)
    scores = tied_scores(rng, (m, n))
    ids = np.tile(np.arange(n, dtype=np.int32), (m, 1))
    ids[rng.random((m, n)) < 0.15] = -1
    tau = rng.uniform(-1, 1, m).astype(np.float32)
    tau[0] = -np.inf
    if m > 1:
        ids[1] = -1
        tau[1] = -np.inf
    if m > 2:
        tau[2] = 0.5
    return scores, ids, tau


# (M, N): one thread per row (N <= 32), one warp per tile with and
# without 16-byte loads (N % 4), partial last tiles, the deployment chunk
LM_CASES = [(5, 40), (3, 512), (4, 600), (2, 1024), (3, 1500), (6, 7),
            (40, 16), (64, 8192), (3, 8190)]


def lm_chunks(m, widths, seed):
    """Logmem chunks of the given widths: ids continue per row across
    chunks, 10% pads, tied scores; row 1 is all pad in the fourth chunk."""
    rng = np.random.default_rng(seed)
    out, lo = [], 0
    for c, w in enumerate(widths):
        s = tied_scores(rng, (m, w))
        i = np.tile(np.arange(lo, lo + w, dtype=np.int32), (m, 1))
        pad = rng.random((m, w)) < 0.1
        if c == 3:
            pad[1] = True
        s[pad], i[pad] = -np.inf, -1
        out.append((s, i))
        lo += w
    return out


def mixed_fleet_specs(spec_cls, docs=192, seed=5):
    """Six exact K=4 streams and five logmem K=64 tenants, and their
    traces."""
    rng = np.random.default_rng(seed)
    specs = [spec_cls(stream_id=i, k=4, r=float(docs / 2)) for i in range(6)]
    specs += [spec_cls(stream_id=100 + i, k=64, r=float(docs / 2),
                       engine="logmem") for i in range(5)]
    traces = rng.standard_normal((len(specs), docs)).astype(np.float32)
    return specs, traces


def ingest_mixed(eng, specs, traces, rng, batch=8, only_sids=None):
    """Route the traces as shuffled mixed batches of ``batch`` docs per
    stream."""
    sids = np.array([s.stream_id for s in specs])
    keep = (np.isin(sids, list(only_sids)) if only_sids is not None
            else np.ones(sids.size, bool))
    for t in range(0, traces.shape[1], batch):
        ms = np.repeat(sids[keep], batch)
        md = np.tile(np.arange(t, t + batch), int(keep.sum()))
        sc = traces[keep, t:t + batch].reshape(-1)
        perm = rng.permutation(ms.size)
        eng.ingest(ms[perm], sc[perm], md[perm])


def tf_case(n, seed, dtype=np.float32):
    """One stream's scores with ties and a few NaNs."""
    rng = np.random.default_rng(seed)
    s = tied_scores(rng, n)
    s[rng.random(n) < 0.01] = np.nan
    return s.astype(dtype)


# N: under one tile, one tile, several tiles of 4096 with a partial last
# one (5000, 100000), N % 4 != 0 (no 16-byte loads), a million
TF_CASES = [100, 128, 4096, 5000, 100_000, 4097, 1 << 20]


def self_check_fleet(m, docs, rng):
    specs = []
    for i in range(m):
        k = (4, 8, 16, 32)[i % 4]
        cm = t_costs.hbm_host_preset(
            n_docs=docs, k=k, doc_gb=float(rng.uniform(1e-6, 1e-4)),
            window_seconds=float(rng.uniform(10, 600)), hbm_bw_gbps=819.0,
            host_link_gbps=float(rng.uniform(8, 64)),
            hbm_capacity_premium=float(rng.uniform(5, 500)))
        specs.append(t_eng.StreamSpec(stream_id=i, k=k, cost_model=cm))
    return specs


def run_self_check(device, m=48, docs=128, batch=32):
    """The metered multi-tenant self-check: survivors must bit-match
    independent simulator replays, and finalize_tiers must equal the
    meter's final-read attribution."""
    rng = np.random.default_rng(0)
    specs = self_check_fleet(m, docs, rng)
    eng = t_eng.StreamEngine(specs, device=device)
    traces = rng.standard_normal((m, docs)).astype(np.float32)
    for t in range(0, docs, batch):
        sids = np.repeat(np.arange(m), batch)
        dids = np.tile(np.arange(t, t + batch), m)
        perm = rng.permutation(sids.size)
        eng.ingest(sids[perm], traces[:, t:t + batch].reshape(-1)[perm],
                   dids[perm])
    survivors = eng.finalize()
    for i, spec in enumerate(specs):
        pol = t_place.Policy(r=eng.meter.rs[eng.stream_row(i)],
                             migrate_at_r=eng.plan.migrate(i))
        sim = t_sim.simulate(traces[i].astype(np.float64), spec.k, pol)
        np.testing.assert_array_equal(survivors[i], sim.survivor_ids)
    for sid, out in eng.finalize_tiers().items():
        row = eng.stream_row(sid)
        valid = out["ids"] >= 0
        host = eng.meter._effective_tier(np.array([row]), out["ids"][None])[0]
        np.testing.assert_array_equal(out["tiers"][valid], host[valid])
        np.testing.assert_array_equal(out["counts"], eng.meter.reads[row])
    return eng


def dense_chunks(m, w, n_chunks, seed):
    rng = np.random.default_rng(seed)
    for c in range(n_chunks):
        s = rng.standard_normal((m, w)).astype(np.float32)
        if c == 1:
            s[0, 3] = np.nan
        yield [(s, np.tile(np.arange(c * w, (c + 1) * w, dtype=np.int32),
                           (m, 1)))]


def uniform_engine(module, device=None):
    specs = [module.StreamSpec(stream_id=i, k=8,
                               boundaries=(30.0, 70.0), migrate=i % 2 == 1)
             for i in range(16)]
    return (module.StreamEngine(specs) if device is None
            else module.StreamEngine(specs, device=device))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", BTK_CASES)
def test_batched_topk_kernel_equals_plain(m, n, cuda_device):
    scores, bars = btk_case(m, n, n)
    s, b = (torch.tensor(x, device=cuda_device) for x in (scores, bars))
    before = t_btk.launches
    out = t_btk.batched_topk_filter(s, b)
    torch.cuda.synchronize()
    assert t_btk.launches == before + 1
    for a, r in zip(out, t_btk.reference(s, b)):
        assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,b", TA_CASES)
def test_tier_assign_kernel_equals_plain(m, k, b, cuda_device):
    ids, bounds, floor = ta_case(m, k, b, k)
    args = [torch.tensor(x, device=cuda_device) for x in
            (ids, t_ta.quantize_boundaries(bounds), floor)]
    before = t_ta.launches
    out = t_ta.tier_assign(*args)
    torch.cuda.synchronize()
    assert t_ta.launches == before + 1
    for a, r in zip(out, t_ta.reference(*args, b + 1)):
        assert torch.equal(a, r)


@pytest.mark.cuda
def test_engine_on_card_equals_cpu(cuda_device):
    cpu = uniform_engine(t_eng, "cpu")
    gpu = uniform_engine(t_eng, cuda_device)
    b0, t0 = t_btk.launches, t_ta.launches
    cpu.ingest_chunks(dense_chunks(16, 16, 8, 3))
    assert gpu.ingest_chunks(dense_chunks(16, 16, 8, 3)) == 8
    assert t_btk.launches == b0 + 8
    for a, b in zip(cpu.states()[0], gpu.states()[0]):
        assert torch.equal(a, b.cpu())
    for f in METER_FIELDS:
        np.testing.assert_array_equal(getattr(cpu.meter, f),
                                      getattr(gpu.meter, f), err_msg=f)
    ct, gt = cpu.finalize_tiers(), gpu.finalize_tiers()
    assert t_ta.launches == t0 + 1
    for sid in ct:
        for key in ("ids", "tiers", "counts"):
            np.testing.assert_array_equal(ct[sid][key], gt[sid][key])


@pytest.mark.cuda
def test_self_check_on_card(cuda_device):
    run_self_check(cuda_device)


@pytest.mark.cuda
def test_double_buffered_ingest_equals_sequential_on_card(cuda_device):
    """ingest_chunks (pinned buffers, side-stream copies) against one
    ingest_dense per chunk, both on the card, at a width where the next
    chunk's copy overlaps the running step."""
    m, w, n_chunks = 200_000, 16, 12
    specs = [t_eng.StreamSpec(stream_id=i, k=8, boundaries=(64.0, 128.0))
             for i in range(m)]
    piped = t_eng.StreamEngine(specs, device=cuda_device)
    plain = t_eng.StreamEngine(specs, device=cuda_device)
    assert piped.ingest_chunks(dense_chunks(m, w, n_chunks, 5),
                               meter=False) == n_chunks
    for dense in dense_chunks(m, w, n_chunks, 5):
        plain.ingest_dense(dense, meter=False)
    for a, b in zip(piped.states()[0], plain.states()[0]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", LM_CASES)
def test_logmem_admit_kernel_equals_plain(m, n, cuda_device):
    scores, ids, tau = lm_admit_case(m, n, n)
    for taus in (tau, np.full_like(tau, -np.inf)):
        args = [torch.tensor(x, device=cuda_device)
                for x in (scores, ids, taus)]
        before = t_lm_ops.launches
        out = t_lm_ops.logmem_admit(*args)
        torch.cuda.synchronize()
        assert t_lm_ops.launches == before + 1
        for a, r in zip(out, t_lm_ops.reference(*args)):
            assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("n", TF_CASES)
def test_topk_filter_kernel_equals_plain(n, cuda_device):
    for dtype in (torch.float32, torch.bfloat16):
        s = torch.tensor(tf_case(n, n), device=cuda_device).to(dtype)
        for thr in (0.5, float("-inf"), 100.0):
            t = torch.tensor(thr, device=cuda_device)
            before = t_tf.launches
            out = t_tf.topk_filter(s, t)
            torch.cuda.synchronize()
            assert t_tf.launches == before + 1
            for a, r in zip(out, t_tf.reference(s, t)):
                assert torch.equal(a, r)


@pytest.mark.cuda
def test_filter_then_merge_on_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(7)
    cpu = t_topk.init(32, device="cpu")
    gpu = t_topk.init(32, device=cuda_device)
    for step in range(5):
        s = tied_scores(rng, 5000)
        i = np.arange(step * 5000, (step + 1) * 5000, dtype=np.int32)
        cpu, cw = t_tf.filter_then_merge(cpu, torch.tensor(s),
                                         torch.tensor(i))
        gpu, gw = t_tf.filter_then_merge(
            gpu, torch.tensor(s, device=cuda_device),
            torch.tensor(i, device=cuda_device))
        assert torch.equal(cw, gw.cpu())
        for a, b in zip(cpu, gpu):
            assert torch.equal(a, b.cpu())


def mixed_dense_chunks(n_chunks, seed):
    """Two buckets of different widths: 16 exact K=8 streams x 16 and 4
    logmem K=256 tenants x 512, NaN and Inf in the second chunk."""
    rng = np.random.default_rng(seed)
    for c in range(n_chunks):
        s0 = rng.standard_normal((16, 16)).astype(np.float32)
        s1 = tied_scores(rng, (4, 512))
        if c == 1:
            s0[0, 3], s1[1, 7] = np.nan, np.inf
        yield [(s0, np.tile(np.arange(16 * c, 16 * c + 16, dtype=np.int32),
                            (16, 1))),
               (s1, np.tile(np.arange(512 * c, 512 * c + 512,
                                      dtype=np.int32), (4, 1)))]


def mixed_engine(device):
    specs = [t_eng.StreamSpec(stream_id=i, k=8, boundaries=(30.0, 70.0),
                              migrate=i % 2 == 1) for i in range(16)]
    specs += [t_eng.StreamSpec(stream_id=100 + i, k=256, r=1024.0,
                               engine="logmem") for i in range(4)]
    return t_eng.StreamEngine(specs, device=device)


@pytest.mark.cuda
def test_mixed_engine_on_card_equals_cpu(cuda_device):
    """Exact and logmem buckets in one double-buffered ingest on the card
    against the same engine on the CPU: every state leaf, every meter
    counter, finalize_tiers; the logmem epilogue's sorts on CUDA keep the
    CPU's order."""
    cpu, gpu = mixed_engine("cpu"), mixed_engine(cuda_device)
    b0, l0 = t_btk.launches, t_lm_ops.launches
    cpu.ingest_chunks(mixed_dense_chunks(12, 4))
    assert gpu.ingest_chunks(mixed_dense_chunks(12, 4)) == 12
    assert (t_btk.launches - b0, t_lm_ops.launches - l0) == (12, 12)
    for cs, gs in zip(cpu.states(), gpu.states()):
        for a, b in zip(cs, gs):
            assert torch.equal(a, b.cpu())
    for f in METER_FIELDS + ("logmem",):
        np.testing.assert_array_equal(getattr(cpu.meter, f),
                                      getattr(gpu.meter, f), err_msg=f)
    ct, gt = cpu.finalize_tiers(), gpu.finalize_tiers()
    assert ct.keys() == gt.keys() == set(range(16))
    for sid in ct:
        for key in ("ids", "tiers", "counts"):
            np.testing.assert_array_equal(ct[sid][key], gt[sid][key])


@pytest.mark.cuda
def test_log2_floors_powers_of_two_on_card(cuda_device):
    """The phase rule ⌊log₂(t/K)⌋ needs log2 exact at powers of two."""
    x = torch.tensor([2.0 ** p for p in range(31)], device=cuda_device)
    assert torch.floor(torch.log2(x)).int().tolist() == list(range(31))
