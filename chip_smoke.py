"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: the four CUDA kernels compiled with nvcc for sm_90a from the
   sources in the checkout (into build/kernels/), all at once; then the
   logmem phase rule's premise on the card: torch.log2 of 2^p floors to
   p for p = 0..30;
3. parity: each kernel against its plain PyTorch version on the card at
   its paths' shapes (1,000,000 streams; 64 and 4096 logmem tenants x
   8192; one stream of 2^20 and 2^26 scores) and edge cases; exact;
4. timings: each kernel, its plain version and its byte bound;
5. main path at full width — the defaults of examples/million_streams.py:
   1,000,000 streams, 3 tiers, K=8, planned by the port's host planner,
   256 docs per stream ingested with ingest_chunks in 16 chunks of 16,
   meter off, then finalize_tiers; launch counters, per-tier counts and
   256 sampled streams against core.simulator replays;
6. metered self-check at the defaults of examples/multi_tenant_streams.py:
   1024 tenants, survivors against simulator replays and finalize_tiers
   against the meter's attribution; its own launch counters must show
   both kernels on this path too;
7. a torch.profiler profile of full-width steps: the compute engine's
   busy share and that of any engine (compute or copy);
8. mixed fleet at full width — examples/million_streams.py
   --logmem-streams 64 on one card: phase 5's plan for the 1,000,000
   exact streams plus 64 logmem tenants at K=65536 (r = 4K), 16 chunks
   of (1,000,000 x 16) and (64 x 8192) through ingest_chunks, meter off,
   then finalize_tiers; the example's law and memory checks, launch
   counters, 256 sampled exact streams against simulator replays, and
   every logmem state leaf and chunk write mask against the port's own
   CPU run of the same chunks; docs/s beside phase 5's, and a profile of
   mixed steps as in phase 7;
9. huge-K harness: logmem.trace_competitive_ratio at the reference's
   RATIO_SWEEP (benchmarks/streams_bench.py) on the card, held to the
   1 - c/sqrt(K) guarantee and to the port's CPU run;
10. single-stream path: filter_then_merge at K=1024 over 64 batches of
   2^20 scores, survivors against numpy's top-1024 of the whole trace.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
repository's sources beside it, the script exits non-zero and prints no
result.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

M = 1_000_000  # streams on the main path
K = 8
DOCS = 256  # docs per stream in a window
CHUNK = 16  # docs per stream per chunk
TIMED_WINDOWS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
LM_STREAMS, LM_K, LM_CHUNK = 64, 65_536, 8_192  # the example's logmem tenants
LM_FLEET = 4096  # a fleet of huge-K tenants, for the kernel's timing
# (K, streams, docs, chunk) of benchmarks/streams_bench.py's RATIO_SWEEP
RATIO_SWEEP = ((256, 64, 16_384, 512), (4_096, 8, 131_072, 2_048),
               (65_536, 2, 262_144, 8_192))
TF_K, TF_BATCH, TF_BATCHES = 1024, 1 << 20, 64  # the single-stream path


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events, after
    two warm-up calls)."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(outs, refs):
    """Exact comparison of a kernel's outputs with its plain version's;
    returns the largest absolute difference (0.0 when equal)."""
    worst = 0.0
    for a, b in zip(outs, refs):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        # equal entries (infinities included) differ by 0
        diff = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
        worst = max(worst, float(diff.nan_to_num(float("inf")).max()))
        if not torch.equal(a, b):
            raise AssertionError(f"kernel differs from its plain version "
                                 f"(max abs diff {worst})")
    return worst


# ---------------------------------------------------------------------------
# phases 1-2: environment and build
# ---------------------------------------------------------------------------

def environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    return smi


def build_kernels():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    log(f"build: {len(reports)} kernels compiled in "
        f"{time.perf_counter() - t0:.2f}s into {build.BUILD_DIR}")
    for name, text in reports.items():
        usage = [ln.split("info    :")[-1].strip()
                 for ln in text.splitlines() if "registers" in ln]
        log(f"build {name}: {' | '.join(usage)}")


def log2_rule():
    """The logmem phase is floor(log2(t/K)) in float32: torch.log2 on the
    card must be exact at powers of two, directly and as t/K."""
    p = torch.arange(31, device="cuda", dtype=torch.int32)
    direct = torch.floor(torch.log2(torch.exp2(p.float()))).int()
    t = torch.exp2(p[:16].float()) * LM_K  # t/K = 2^p, t < 2^31
    kf = torch.full_like(t, float(LM_K))
    ratio = torch.floor(torch.log2(torch.maximum(t / kf, torch.ones_like(t))))
    if not (torch.equal(direct, p) and torch.equal(ratio.int(), p[:16])):
        raise AssertionError(f"floor(log2(2^p)) on the card is not p: "
                             f"{direct.tolist()} {ratio.int().tolist()}")
    log("log2 rule: floor(torch.log2(2^p)) == p on the card for p = 0..30, "
        f"and floor(log2(t/K)) == p at K={LM_K}, t = K*2^p, p = 0..15")


# ---------------------------------------------------------------------------
# phases 3-4: kernel parity and timings
# ---------------------------------------------------------------------------

def btk_inputs(g, n, kind):
    scores = torch.randn(M, n, device="cuda", generator=g)
    bars = torch.randn(M, device="cuda", generator=g)
    if kind == "unfull":
        bars[::2] = float("-inf")
    elif kind == "ties":
        scores[:, ::3] = 0.5
        bars[::2] = 0.5
        bars[1::2] = scores[1::2, n // 2]
    return scores.contiguous(), bars


def ta_inputs(g, k, b, floors):
    from repro_torch.kernels.tier_assign import ops as ta
    ids = torch.randint(0, DOCS, (M, k), device="cuda", dtype=torch.int32,
                        generator=g)
    ids[::3, k // 2:] = -1
    rng = np.random.default_rng(k * 10 + b)
    bounds = np.sort(rng.uniform(0, DOCS, (M, b)), axis=1)
    bounds[::5, -1] = np.inf
    bounds[::7, 0] = -np.inf
    bq = torch.tensor(ta.quantize_boundaries(bounds), device="cuda")
    floor = (torch.randint(0, b + 1, (M,), device="cuda", dtype=torch.int32,
                           generator=g) if floors
             else torch.zeros(M, device="cuda", dtype=torch.int32))
    return ids, bq, floor


def lm_inputs(g, m, n, kind):
    """Logmem admission inputs: pad ids between live ones (10%), every
    97th row all pad, every third threshold -inf; ``ninf``: all -inf
    (pads must stay inert); ``ties``: thresholds equal to scores."""
    scores = torch.randn(m, n, device="cuda", generator=g)
    ids = torch.arange(n, dtype=torch.int32, device="cuda").repeat(m, 1)
    ids[torch.rand(m, n, device="cuda", generator=g) < 0.1] = -1
    ids[1::97] = -1
    tau = torch.randn(m, device="cuda", generator=g)
    tau[::3] = float("-inf")
    if kind == "ninf":
        tau.fill_(float("-inf"))
    elif kind == "ties":
        scores[:, ::3] = 0.5
        tau[1::3] = 0.5
    return scores, ids, tau


def tf_inputs(g, n, kind):
    """One stream's scores and a threshold: 0.5, -inf (pad columns
    counted), above every score, or 0.5 with NaN scores."""
    s = torch.randn(n, device="cuda", generator=g)
    if kind == "nan":
        s[::101] = float("nan")
    thr = {"ninf": float("-inf"), "below": 100.0}.get(kind, 0.5)
    return s, torch.tensor(thr, device="cuda")


def kernel_parity():
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.logmem_update import ops as lm
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.kernels.topk_filter import ops as tf
    g = torch.Generator(device="cuda").manual_seed(0)
    errs = {"batched_topk": 0.0, "tier_assign": 0.0, "logmem_update": 0.0,
            "topk_filter": 0.0}
    for n, kind, label in ((16, "unfull", "-inf bars: pad columns counted"),
                           (16, "ties", "bars equal to scores"),
                           (16, "plain", "main-path width"),
                           (7, "unfull", "N=7, -inf bars"),
                           (600, "unfull", "N=600, two tiles, -inf bars")):
        s, b = btk_inputs(g, n, kind)
        out = btk.batched_topk_filter(s, b)
        torch.cuda.synchronize()
        err = max_abs_err(out, btk.reference(s, b))
        errs["batched_topk"] = max(errs["batched_topk"], err)
        log(f"parity batched_topk [{label}] M={M} N={n}: exact "
            f"(max abs diff {err})")
    for k, b, floors, label in ((8, 2, True, "floors, ±inf bounds, -1 pads"),
                                (8, 2, False, "no floors"),
                                (5, 3, True, "K=5, 4 tiers"),
                                (40, 2, True, "K=40, two lane rounds")):
        ids, bq, floor = ta_inputs(g, k, b, floors)
        out = ta.tier_assign(ids, bq, floor)
        torch.cuda.synchronize()
        err = max_abs_err(out, ta.reference(ids, bq, floor, b + 1))
        errs["tier_assign"] = max(errs["tier_assign"], err)
        log(f"parity tier_assign [{label}] M={M} K={k} B={b}: exact "
            f"(max abs diff {err})")
    for m, n, kind, label in (
            (LM_STREAMS, LM_CHUNK, "plain", "deployment chunk"),
            (LM_FLEET, LM_CHUNK, "plain", "fleet of huge-K tenants"),
            (LM_STREAMS, LM_CHUNK, "ninf", "tau=-inf everywhere"),
            (LM_FLEET, 600, "ties", "N=600, two tiles, ties"),
            (LM_FLEET, 40, "plain", "N=40"),
            (LM_FLEET, 16, "ninf", "N=16, one thread per row"),
            (LM_FLEET, 8190, "plain", "N=8190, 4-byte loads")):
        args = lm_inputs(g, m, n, kind)
        out = lm.logmem_admit(*args)
        torch.cuda.synchronize()
        err = max_abs_err(out, lm.reference(*args))
        errs["logmem_update"] = max(errs["logmem_update"], err)
        log(f"parity logmem_update [{label}; pad ids between live ones, "
            f"all-pad rows] M={m} N={n}: exact (max abs diff {err})")
    for n, kind, dtype, label in (
            (TF_BATCH, "plain", torch.float32, "main-path batch"),
            (TF_BATCH * TF_BATCHES, "plain", torch.float32, "2^26 scores"),
            (5000, "plain", torch.float32, "N=5000, partial tile"),
            (5000, "ninf", torch.float32, "thr=-inf, pads counted"),
            (TF_BATCH, "nan", torch.float32, "NaN scores"),
            (TF_BATCH, "below", torch.float32, "all below thr"),
            (TF_BATCH, "plain", torch.bfloat16, "bfloat16 scores"),
            (4097, "ninf", torch.float32, "N=4097, 4-byte loads")):
        s, thr = tf_inputs(g, n, kind)
        s = s.to(dtype)
        out = tf.topk_filter(s, thr)
        torch.cuda.synchronize()
        err = max_abs_err(out, tf.reference(s, thr))
        errs["topk_filter"] = max(errs["topk_filter"], err)
        log(f"parity topk_filter [{label}] N={n}: exact (max abs diff "
            f"{err})")
    return errs


def device_ms(fn, reps, kernel):
    """Mean device time per launch of the kernel ``fn`` launches, whose
    name contains ``kernel``: torch.profiler over ``reps`` calls after a
    warm-up call. The kernel's own time, without the host's launch
    overhead, which a CUDA-event timing of a short kernel measures."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    runs = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and kernel in e.name]
    if len(runs) != reps:
        raise AssertionError(f"profiled {len(runs)} launches of {kernel}, "
                             f"not {reps}")
    return sum(e.time_range.end - e.time_range.start
               for e in runs) / reps / 1e3  # microseconds -> ms


def kernel_timings():
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.logmem_update import ops as lm
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.kernels.topk_filter import ops as tf
    g = torch.Generator(device="cuda").manual_seed(1)
    n_bounds, n_tiers = 2, 3
    cases = []  # (key, kernel name in the profile, call, plain, bytes, shape)
    s, b = btk_inputs(g, CHUNK, "plain")
    cases.append((
        "batched_topk", "scan_", lambda: btk.batched_topk_filter(s, b),
        lambda: btk.reference(s, b),
        4 * M * CHUNK + 4 * M + M * CHUNK + 8 * M,
        f"scores ({M}, {CHUNK}) f32, bars ({M},) f32"))
    ids, bq, floor = ta_inputs(g, K, n_bounds, True)
    cases.append((
        "tier_assign", "assign_", lambda: ta.tier_assign(ids, bq, floor),
        lambda: ta.reference(ids, bq, floor, n_tiers),
        4 * M * K + 4 * M * n_bounds + 4 * M + 4 * M * K + 4 * M * n_tiers,
        f"ids ({M}, {K}) i32, bounds ({M}, {n_bounds}) i32"))
    # the path's shape first (it goes into the kernels line), then a
    # large one
    lm_tiles = -(-LM_CHUNK // lm.tile_width(LM_CHUNK))
    for m, key in ((LM_STREAMS, "logmem_update"),
                   (LM_FLEET, "logmem_update@fleet")):
        a = lm_inputs(g, m, LM_CHUNK, "plain")
        cases.append((
            key, "admit_", lambda a=a: lm.logmem_admit(*a),
            lambda a=a: lm.reference(*a),
            8 * m * LM_CHUNK + 4 * m + m * LM_CHUNK + 12 * m * lm_tiles,
            f"scores and ids ({m}, {LM_CHUNK}), tau ({m},)"))
    for n, key in ((TF_BATCH, "topk_filter"),
                   (TF_BATCH * TF_BATCHES, "topk_filter@2^26")):
        a = tf_inputs(g, n, "plain")
        cases.append((
            key, "filter_tile", lambda a=a: tf.topk_filter(*a),
            lambda a=a: tf.reference(*a),
            4 * n + 4 + n + 8 * -(-n // tf.tile_width(n)),
            f"scores ({n},) f32, thr () f32"))
    out = {}
    for key, kernel, call, plain, nbytes, shape in cases:
        out[key] = {"ms": device_ms(call, 100, kernel),
                    "call_ms": cuda_ms(call, 200),
                    "plain_ms": cuda_ms(plain, 10),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "library_ms": None}
        t = out[key]
        log(f"timing {key} [{shape}]: kernel {t['ms']:.4f} ms on the device "
            f"(profiler); {t['call_ms']:.4f} ms per wrapper call (CUDA "
            f"events, host launch included); plain {t['plain_ms']:.4f} ms; "
            f"byte bound {t['bound_ms']:.4f} ms at 3.35 TB/s")
    for name, call in (("batched_topk", "torch.gt gives the mask alone"),
                       ("tier_assign", "torch.bucketize gives the uncapped "
                        "tier index alone"),
                       ("logmem_update", "torch.gt with an id gate gives "
                        "the mask alone"),
                       ("topk_filter", "torch.gt gives the mask alone")):
        log(f"library_ms {name}: null — no single PyTorch call gives the "
            f"kernel's mask (or tiers) together with its per-tile or "
            f"per-tier counts and maxima ({call})")
    return out


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def fleet_cost_arrays(rng, m, n_docs, k):
    """Per-stream 3-tier (hot/warm/cold) cost arrays of
    examples/million_streams.py: write-cheap read-expensive hot tier, the
    reverse cold, jittered per stream."""
    jit = lambda lo, hi: rng.uniform(lo, hi, m)  # noqa: E731
    cw = np.stack([jit(0.8, 1.2) * 1e-6, jit(0.8, 1.2) * 2e-5,
                   jit(0.8, 1.2) * 8e-5], axis=1)
    cr = np.stack([jit(0.8, 1.2) * 2.7e-4, jit(0.8, 1.2) * 4e-5,
                   jit(0.8, 1.2) * 1e-6], axis=1)
    cs = np.stack([jit(0.8, 1.2) * 2.5e-6, jit(0.8, 1.2) * 1e-6,
                   jit(0.8, 1.2) * 2.5e-7], axis=1)
    return (cw, cr, cs, np.full(m, float(n_docs)), np.full(m, float(k)),
            rng.uniform(0.5, 4.0, m))


def plan_fleet(rng, hot_frac=0.6):
    """The example's plan: closed-form solve, fleet-shared hot-tier
    budget water-filled, binding streams re-solved under their grant."""
    from repro_torch.core import constraints as cons
    from repro_torch.core import shp
    from repro_torch.streams import planner
    cw, cr, cs, n, kv, rpw = fleet_cost_arrays(rng, M, DOCS, K)
    t0 = time.perf_counter()
    plan = shp.plan_ntier_arrays(cw, cr, cs, n, kv, rpw)
    t_solve = time.perf_counter() - t0
    bounds, mig = plan["bounds"].copy(), plan["migrate"].copy()
    desired = cons.peak_occupancy_arrays(bounds, n, kv, mig)[:, 0]
    budget = float(desired.sum()) * hot_frac
    grants = planner.waterfill(desired, budget)
    idx = np.flatnonzero(grants < desired - 1e-9)
    t0 = time.perf_counter()
    cap = np.full((idx.size, 3), np.inf)
    cap[:, 0] = grants[idx]
    re = shp.plan_ntier_arrays(cw[idx], cr[idx], cs[idx], n[idx], kv[idx],
                               rpw[idx], cap=cap)
    bounds[idx], mig[idx] = re["bounds"], re["migrate"]
    t_resolve = time.perf_counter() - t0
    hot = cons.peak_occupancy_arrays(bounds, n, kv, mig)[:, 0].sum()
    if not hot <= budget * (1 + 1e-9) + 1e-6:
        raise AssertionError("hot-tier budget oversubscribed")
    log(f"plan: {M} streams, 3 tiers: solve {t_solve:.3f}s, constrained "
        f"re-solve of {idx.size} binding streams {t_resolve:.3f}s; hot "
        f"peak {hot:.0f} <= budget {budget:.0f}; {int(mig.sum())} migrating")
    return bounds, mig


def window_chunks(rng, window, n_chunks=DOCS // CHUNK):
    """The ingest_dense-shaped chunks of one window, made on the host
    before any clock starts (doc ids continue across windows)."""
    out = []
    for c in range(n_chunks):
        lo = window * DOCS + c * CHUNK
        ids = np.tile(np.arange(lo, lo + CHUNK, dtype=np.int32), (M, 1))
        out.append([(rng.standard_normal((M, CHUNK), dtype=np.float32),
                     ids)])
    return out


def check_sample(eng, sample, trace, bounds, mig, tiers=None):
    """Survivors of the sampled streams against independent simulator
    replays of their traces; with ``tiers`` (finalize_tiers' output),
    the tiers of statically placed streams against the policy too."""
    from repro_torch.core import placement, simulator
    ids = eng.states()[0].ids[torch.as_tensor(sample, device=eng.device)]
    ids = ids.cpu().numpy()
    bad = 0
    for j, row in enumerate(sample):
        pol = placement.Policy(boundaries=tuple(bounds[row]),
                               migrate_at_r=bool(mig[row]))
        sim = simulator.simulate(trace[j].astype(np.float64), K, pol)
        ok = np.array_equal(np.sort(ids[j][ids[j] >= 0]), sim.survivor_ids)
        if ok and tiers is not None and not mig[row]:
            t_row = tiers[int(row)]
            ok = [pol.tier_of(int(d)) for d in t_row["ids"]] == \
                t_row["tiers"].tolist()
        bad += not ok
    log(f"main path: {len(sample) - bad}/{len(sample)} sampled streams "
        f"bit-match their simulator replay over {trace.shape[1]} docs")
    if bad:
        raise AssertionError("main path diverged from simulator replays")


def main_path():
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.streams import StreamEngine, StreamSpec
    rng = np.random.default_rng(0)
    bounds, mig = plan_fleet(rng)
    t0 = time.perf_counter()
    eng = StreamEngine([StreamSpec(stream_id=i, k=K, boundaries=tuple(b),
                                   migrate=bool(g))
                        for i, (b, g) in enumerate(zip(bounds.tolist(),
                                                       mig.tolist()))])
    log(f"engine: built for {M} streams on {eng.device} in "
        f"{time.perf_counter() - t0:.3f}s")
    first = window_chunks(rng, 0)
    n_chunks = len(first)

    # the counted run: counters to 0, drive, read
    btk.launches = ta.launches = 0
    t0 = time.perf_counter()
    done = eng.ingest_chunks(first, meter=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiers = eng.finalize_tiers()
    t_fin = time.perf_counter() - t0
    launches = {"batched_topk": btk.launches, "tier_assign": ta.launches}
    log(f"main-path launches: {launches}")
    t0 = time.perf_counter()
    eng.assign_tiers()
    torch.cuda.synchronize()
    log(f"assign_tiers (floor copy and tier_assign, no per-stream dict): "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms for {M} streams")
    if launches["batched_topk"] != n_chunks or launches["tier_assign"] < 1:
        raise AssertionError(f"main path missed a kernel: {launches}")
    docs = M * CHUNK * done
    log(f"ingest, first window (warm-up): {done} chunks, {docs} docs in "
        f"{t_first:.4f}s = {docs / t_first:.6g} docs/s")
    log(f"finalize_tiers: {t_fin:.3f}s for {M} streams (assign_tiers plus "
        f"the per-stream result dict)")

    counts = np.stack([tiers[i]["counts"] for i in range(M)])
    if int(counts.sum()) != M * K:
        raise AssertionError(f"per-tier counts sum {counts.sum()} != M*K")
    log(f"finalize_tiers: counts sum {int(counts.sum())} = M*K; per tier "
        f"{counts.sum(0).tolist()}")

    # 256 sampled streams against independent simulator replays, after
    # the counted window and again after the timed ones (the double
    # buffer in steady state)
    sample = np.sort(rng.choice(M, 256, replace=False))
    trace = np.concatenate([ch[0][0][sample] for ch in first], axis=1)
    check_sample(eng, sample, trace, bounds, mig, tiers)

    rates = []
    for w in range(1, TIMED_WINDOWS + 1):
        chunks = window_chunks(rng, w)
        trace = np.concatenate([trace] + [ch[0][0][sample] for ch in chunks],
                               axis=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.ingest_chunks(chunks, meter=False)
        torch.cuda.synchronize()
        rates.append(M * CHUNK * len(chunks) / (time.perf_counter() - t0))
    log(f"ingest, {TIMED_WINDOWS} windows after the warm-up: median "
        f"{statistics.median(rates):.6g} docs/s, min {min(rates):.6g}, "
        f"max {max(rates):.6g} (16 chunks of {M} x {CHUNK} per window, "
        f"host-made chunks; host clock around ingest_chunks and a sync)")
    check_sample(eng, sample, trace, bounds, mig)
    rate = {"first": docs / t_first, "median": statistics.median(rates)}
    return eng, launches, rng, (bounds, mig, rate)


# ---------------------------------------------------------------------------
# phase 6: metered self-check
# ---------------------------------------------------------------------------

def self_check():
    from repro_torch.core import costs, placement, simulator
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.streams import StreamEngine, StreamSpec
    m, docs, batch = 1024, 256, 32
    rng = np.random.default_rng(0)
    specs = []
    for i in range(m):
        k = (4, 8, 16, 32)[i % 4]
        cm = costs.hbm_host_preset(
            n_docs=docs, k=k, doc_gb=float(rng.uniform(1e-6, 1e-4)),
            window_seconds=float(rng.uniform(10.0, 600.0)),
            hbm_bw_gbps=819.0, host_link_gbps=float(rng.uniform(8.0, 64.0)),
            hbm_capacity_premium=float(rng.uniform(5.0, 500.0)))
        specs.append(StreamSpec(stream_id=i, k=k, cost_model=cm))
    eng = StreamEngine(specs)
    traces = np.stack([simulator.random_rank_trace(docs, rng)
                       for _ in range(m)]).astype(np.float32)
    sids = np.arange(m)
    # the counted run: counters to 0, drive, read after finalize_tiers
    btk.launches = ta.launches = 0
    t0 = time.perf_counter()
    for t in range(0, docs, batch):
        mixed_sids = np.repeat(sids, batch)
        mixed_dids = np.tile(np.arange(t, t + batch), m)
        perm = rng.permutation(mixed_sids.size)
        eng.ingest(mixed_sids[perm],
                   traces[:, t:t + batch].reshape(-1)[perm],
                   mixed_dids[perm])
    t_ingest = time.perf_counter() - t0
    survivors = eng.finalize()
    match = 0
    for i, spec in enumerate(specs):
        pol = placement.Policy(r=eng.meter.rs[eng.stream_row(i)],
                               migrate_at_r=eng.plan.migrate(i))
        sim = simulator.simulate(traces[i].astype(np.float64), spec.k, pol)
        match += np.array_equal(survivors[i], sim.survivor_ids)
    tiers = eng.finalize_tiers()
    launches = {"batched_topk": btk.launches, "tier_assign": ta.launches}
    n_buckets = len(eng.buckets)
    # every router-fed batch is W=32 >= K wide, so each bucket's step
    # takes filtered_update (batched_topk); finalize_tiers runs one
    # tier_assign per bucket
    want = {"batched_topk": docs // batch * n_buckets,
            "tier_assign": n_buckets}
    log(f"self-check launches: {launches} ({docs // batch} steps x "
        f"{n_buckets} buckets)")
    if launches != want:
        raise AssertionError(f"self-check launches {launches} != {want}")
    agree = 0
    for sid, out in tiers.items():
        row = eng.stream_row(sid)
        valid = out["ids"] >= 0
        host = eng.meter._effective_tier(np.array([row]),
                                         out["ids"][None])[0]
        agree += (np.array_equal(out["tiers"][valid], host[valid])
                  and np.array_equal(out["counts"], eng.meter.reads[row]))
    rec = eng.meter.reconcile(batch=batch)
    log(f"self-check: {m} tenants, K in (4, 8, 16, 32), metered ingest "
        f"{t_ingest:.3f}s; bit-match {match}/{m} simulator replays; "
        f"finalize_tiers == meter attribution {agree}/{m}; writes actual "
        f"{rec['fleet_actual']:.0f} expected {rec['fleet_expected']:.1f}")
    if match != m or agree != m:
        raise AssertionError("self-check failed")


# ---------------------------------------------------------------------------
# phase 7: step profile
# ---------------------------------------------------------------------------

def union_ms(events):
    """Length of the union of the events' time ranges, in ms."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):  # microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def step_profile(eng, chunks, label):
    """Profile ``eng.ingest_chunks`` over ``chunks``: wall and device-busy
    time per step, the top device operations, and the host's staging copy
    of one chunk alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps = len(chunks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.ingest_chunks(chunks, meter=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    any_ms = union_ms(dev) / steps
    # compute engine alone: the host-to-device staging copies run on the
    # copy engine, overlapped with the steps
    compute_ms = union_ms([e for e in dev if "Memcpy" not in e.name]) / steps
    log(f"step profile: {steps} steps of {label}: wall {wall_ms:.3f} "
        f"ms/step (profiler on); compute busy {compute_ms:.3f} ms/step = "
        f"{compute_ms / wall_ms:.3f} of wall; any engine busy (compute or "
        f"copy) {any_ms:.3f} ms/step = {any_ms / wall_ms:.3f} of wall")
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in ops) or 1.0
    for e in ops[:10]:
        log(f"step profile: {e.self_device_time_total / 1e3 / steps:9.4f} "
            f"ms/step {e.self_device_time_total / total:6.3f}  "
            f"{e.key[:90]}")
    if compute_ms <= 0:
        raise AssertionError("the profile saw no device compute time")
    # the host side of staging one chunk: pageable arrays into pinned memory
    dense = [a for pair in chunks[0] for a in pair]
    pinned = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                          pin_memory=True) for a in dense]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for p, a in zip(pinned, dense):
            p.copy_(torch.from_numpy(a))
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"host staging copy of one chunk ({sum(a.nbytes for a in dense)} "
        f"bytes) into pinned memory: {min(times):.3f} ms (min of 3; "
        f"{torch.get_num_threads()} threads)")


# ---------------------------------------------------------------------------
# phase 8: mixed exact + logmem fleet at full width
# ---------------------------------------------------------------------------

def mixed_window_chunks(rng, window, n_chunks=DOCS // CHUNK):
    """``window_chunks`` plus the logmem bucket's pair in every chunk:
    (64 x 8192) scores, ids continuing across chunks and windows."""
    out = window_chunks(rng, window, n_chunks)
    for c, pairs in enumerate(out):
        lo = (window * DOCS // CHUNK + c) * LM_CHUNK
        pairs.append((
            rng.standard_normal((LM_STREAMS, LM_CHUNK), dtype=np.float32),
            np.tile(np.arange(lo, lo + LM_CHUNK, dtype=np.int32),
                    (LM_STREAMS, 1))))
    return out


def mixed_fleet(bounds, mig, rate5):
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.logmem_update import ops as lm_ops
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.streams import StreamEngine, StreamSpec, logmem
    rng = np.random.default_rng(1)
    specs = [StreamSpec(stream_id=i, k=K, boundaries=tuple(b),
                        migrate=bool(g))
             for i, (b, g) in enumerate(zip(bounds.tolist(), mig.tolist()))]
    specs += [StreamSpec(stream_id=M + j, k=LM_K, r=float(4 * LM_K),
                         engine="logmem") for j in range(LM_STREAMS)]
    eng = StreamEngine(specs)
    # buckets in (K, backend) order: the chunks' pairs are (exact, logmem)
    lb = 1
    if [b.engine for b in eng.buckets] != ["exact", "logmem"]:
        raise AssertionError(f"unexpected buckets {eng.buckets}")
    first = mixed_window_chunks(rng, 0)
    n_chunks = len(first)
    # keep each step's logmem write mask (the device tensor) for the
    # comparison with the CPU run below
    wrotes = []
    dispatch = eng._dispatch

    def recording(batches):
        out = dispatch(batches)
        wrotes.append(out[0][lb])
        return out

    eng._dispatch = recording
    # the counted run: counters to 0, drive, read
    btk.launches = ta.launches = lm_ops.launches = 0
    t0 = time.perf_counter()
    done = eng.ingest_chunks(first, meter=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    tiers = eng.finalize_tiers()
    launches = {"logmem_update": lm_ops.launches,
                "batched_topk": btk.launches, "tier_assign": ta.launches}
    del eng._dispatch
    log(f"mixed fleet launches: {launches}")
    want = {"logmem_update": n_chunks, "batched_topk": n_chunks,
            "tier_assign": 1}
    if launches != want:
        raise AssertionError(f"mixed fleet launches {launches} != {want}")
    exact_st, lm_st = eng.states()
    seen = (int(exact_st.seen.sum()), int(lm_st.seen.sum()))
    want_seen = (M * CHUNK * done, LM_STREAMS * LM_CHUNK * done)
    docs = sum(want_seen)
    if seen != want_seen:
        raise AssertionError(f"docs observed {seen} != {want_seen}")
    if set(tiers) != set(range(M)):
        raise AssertionError("finalize_tiers must hold exactly the exact "
                             "streams")
    counts = sum(int(t["counts"].sum()) for t in tiers.values())
    if counts != M * K:
        raise AssertionError(f"per-tier counts sum {counts} != M*K")
    # the example's law and memory checks
    n_lm = LM_CHUNK * done
    law = float(logmem.expected_admits(np.asarray([n_lm]), LM_K)[0])
    slack = logmem.law_slack(LM_K)
    admit_ratio = float(lm_st.admits.double().mean()) / law
    bps = logmem.state_bytes_per_stream(lm_st)
    exact_bps = logmem.exact_bytes_per_stream(LM_K)
    log(f"mixed fleet: {M} exact streams + {LM_STREAMS} logmem tenants at "
        f"K={LM_K}: docs observed {seen[0]} + {seen[1]} = {docs}; logmem "
        f"admits {admit_ratio:.6f}x the write law ({law:.1f} per tenant "
        f"after {n_lm} docs; budget 3*slack = {3 * slack:.6f}); "
        f"{bps:.0f} B/stream vs {exact_bps:.0f} exact "
        f"({exact_bps / bps:.1f}x leaner)")
    if not abs(admit_ratio - 1.0) <= 3.0 * slack:
        raise AssertionError("logmem admits beyond the slack budget")
    if not exact_bps / bps >= 8.0:
        raise AssertionError("logmem state is not 8x leaner")
    # the 64 tenants against the port's own CPU run of the same chunks:
    # holds the torch epilogue (sorts, gathers, f32 arithmetic) on CUDA
    cpu = logmem.init(LM_STREAMS, device="cpu")
    bad = 0
    for c, pairs in enumerate(first):
        s, i = pairs[lb]
        cpu, wrote = logmem.update(cpu, torch.from_numpy(s),
                                   torch.from_numpy(i), LM_K)
        bad += not torch.equal(wrote, wrotes[c].cpu())
    leaves = [name for name, a, b in zip(logmem.LogmemState._fields, cpu,
                                         lm_st)
              if not torch.equal(a, b.cpu())]
    log(f"mixed fleet: logmem tenants on the card vs the CPU run: "
        f"{len(first) - bad}/{len(first)} chunk write masks equal, "
        f"{9 - len(leaves)}/9 state leaves equal bit for bit")
    if bad or leaves:
        raise AssertionError(f"logmem on the card differs from the CPU: "
                             f"{bad} masks, leaves {leaves}")
    sample = np.sort(rng.choice(M, 256, replace=False))
    trace = np.concatenate([ch[0][0][sample] for ch in first], axis=1)
    check_sample(eng, sample, trace, bounds, mig, tiers)
    rates = []
    for w in range(1, 3):
        chunks = mixed_window_chunks(rng, w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.ingest_chunks(chunks, meter=False)
        torch.cuda.synchronize()
        rates.append(docs / (time.perf_counter() - t0))
    log(f"mixed fleet ingest: counted window {docs / t_first:.6g} docs/s, "
        f"2 timed windows {rates[0]:.6g} and {rates[1]:.6g} docs/s "
        f"({docs} docs per window); phase 5 (exact only, {M * DOCS} docs "
        f"per window): first window {rate5['first']:.6g}, median of "
        f"{TIMED_WINDOWS} timed {rate5['median']:.6g} docs/s")
    step_profile(eng, mixed_window_chunks(rng, 3, 4),
                 f"{M} x {CHUNK} exact + {LM_STREAMS} x {LM_CHUNK} logmem")
    return launches


# ---------------------------------------------------------------------------
# phase 9: huge-K harness
# ---------------------------------------------------------------------------

def huge_k_harness():
    from repro_torch.streams import logmem
    rng = np.random.default_rng(2)
    for k, m, n, chunk in RATIO_SWEEP:
        sc = rng.standard_normal((m, n)).astype(np.float32)
        t0 = time.perf_counter()
        rep = logmem.trace_competitive_ratio(sc, k, chunk)
        dt = time.perf_counter() - t0
        cpu = logmem.trace_competitive_ratio(sc, k, chunk, device="cpu")
        slack = logmem.law_slack(k)
        same = all(np.array_equal(rep[key], cpu[key])
                   for key in ("ratio", "admits", "admit_ratio"))
        lo, hi = np.min(rep["admit_ratio"]), np.max(rep["admit_ratio"])
        log(f"huge-K harness K={k} M={m} n={n} chunk={chunk}: min ratio "
            f"{rep['min_ratio']} (>= {1 - slack}), max c {rep['max_c']} "
            f"(<= {logmem.LAW_SLACK_C}), admit ratio {lo}..{hi} (within "
            f"1 +- {3 * slack}); equal to the CPU run: {same}; {dt:.3f}s "
            f"on the card")
        if not (rep["min_ratio"] >= 1.0 - slack
                and rep["max_c"] <= logmem.LAW_SLACK_C
                and np.abs(rep["admit_ratio"] - 1.0).max() <= 3.0 * slack
                and same):
            raise AssertionError(f"huge-K harness failed at K={k}")


# ---------------------------------------------------------------------------
# phase 10: single-stream filter path
# ---------------------------------------------------------------------------

def single_stream():
    from repro_torch.core import topk
    from repro_torch.kernels.topk_filter import ops as tf
    rng = np.random.default_rng(3)
    n = TF_BATCH * TF_BATCHES
    scores = rng.standard_normal(n, dtype=np.float32)
    dev_s = torch.from_numpy(scores).cuda()
    dev_i = torch.arange(n, dtype=torch.int32, device="cuda")
    st = topk.init(TF_K)
    # the counted run: counter to 0, drive, read
    tf.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(TF_BATCHES):
        sl = slice(b * TF_BATCH, (b + 1) * TF_BATCH)
        st, _ = tf.filter_then_merge(st, dev_s[sl], dev_i[sl])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = tf.launches
    log(f"single-stream launches: topk_filter {launches}")
    if launches != TF_BATCHES:
        raise AssertionError(f"topk_filter launched {launches} times, "
                             f"not {TF_BATCHES}")
    # numpy's top-K of the whole trace, ranked by (-score, id)
    kth = np.partition(scores, n - TF_K)[n - TF_K]
    cand = np.flatnonzero(scores >= kth)
    want = cand[np.lexsort((cand, -scores[cand]))][:TF_K]
    got = st.ids.cpu().numpy()
    ok = np.array_equal(got, want) and np.array_equal(
        st.scores.cpu().numpy(), scores[want])
    log(f"single-stream path: filter_then_merge K={TF_K} over "
        f"{TF_BATCHES} batches of {TF_BATCH}: survivors equal numpy's "
        f"top-{TF_K} of {n} scores: {ok}; {n / dt:.6g} docs/s (device-"
        f"resident batches; host clock and a sync)")
    if not ok:
        raise AssertionError("single-stream survivors differ from numpy")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smi = environment()
    build_kernels()
    log2_rule()
    errs = kernel_parity()
    times = kernel_timings()
    eng, launches, rng, (bounds, mig, rate5) = main_path()
    self_check()
    step_profile(eng, window_chunks(rng, 1 + TIMED_WINDOWS, 4),
                 f"{M} x {CHUNK}")
    del eng
    launches["logmem_update"] = mixed_fleet(bounds, mig,
                                            rate5)["logmem_update"]
    huge_k_harness()
    launches["topk_filter"] = single_stream()
    replaces = {
        "batched_topk": "src/repro/kernels/batched_topk/batched_topk.py:32",
        "tier_assign": "src/repro/kernels/tier_assign/tier_assign.py:47",
        "logmem_update":
            "src/repro/kernels/logmem_update/logmem_update.py:40",
        "topk_filter": "src/repro/kernels/topk_filter/topk_filter.py:33"}
    kernels = []
    for name in replaces:
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"]})
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
