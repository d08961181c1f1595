"""repro_torch on a CUDA card: each hand-written kernel against its plain
PyTorch version, and the engine on the card against the engine on the
CPU (double-buffered ingest, finalize_tiers, launch counters). Every test
here is marked ``cuda`` and skips without a card.

The file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Its input-case helpers are shared with the CPU parity tests
(tests/test_torch_kernels.py, tests/test_torch_engine.py).

Tolerance: exact — integer outputs, and maxima that are input elements.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import costs as t_costs
from repro_torch.core import placement as t_place
from repro_torch.core import simulator as t_sim
from repro_torch.kernels.batched_topk import ops as t_btk
from repro_torch.kernels.tier_assign import ops as t_ta
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
