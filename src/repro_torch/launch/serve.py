"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``
— the port of the reference's ``launch.serve`` together with the loop of
its ``examples/serve_topk.py``.

An LM serves batches of requests: prefill of the prompts, then greedy
decoding. Every finished request is scored by its mean predictive entropy
over the decode steps (the ``entropy_scores`` kernel), and the top-K most
"interesting" requests of the window are retained in tiered storage at
the placement the SHP plan chose: the paper's workflow with the serving
fleet as the producer and offline analysis as the consumer.

Retention runs through ``TopKCurator`` + ``TieredStore`` (hot slab on the
device → cold host store), or with ``tenants > 1`` through the
multi-tenant ``streams.StreamEngine``: requests are interleaved across the
tenants, each with its own K, cost model and tier topology (every third
tenant places across HBM → DRAM → disk).

With ``--obs-out`` / ``--obs-port`` the tenant engine runs with the
telemetry layer (``repro_torch.obs``): ``--obs-out DIR`` writes
``metrics.json``, ``metrics.prom`` (Prometheus text) and
``events.jsonl``; ``--obs-port PORT`` serves live ``/metrics`` and
``/snapshot`` on 127.0.0.1 (0 = an ephemeral port, printed at startup)
with cost attribution on; ``--obs-hold SEC`` stretches the loop over at
least SEC seconds so a scraper can watch the counters advance.

With ``--mesh N`` (and ``--tenants > 1``) the tenant engine shards its
fleet axis over a ``parallel.fleet.FleetMesh`` of N shards: N cards when
N are visible, else N shards on the engine's device (as the reference
forces N host devices off-hardware); the startup line says which.

With ``--ckpt-dir DIR`` (and ``--tenants > 1``) a
``repro_torch.resilience.FleetCheckpointer`` writes a crash-consistent
checkpoint of the tenant engine every ``--ckpt-every`` chunks. SIGTERM and
SIGINT only request a stop: the batch in flight finishes, a final
blocking checkpoint is written at the ingest cursor, the obs artifacts
are flushed and the launcher exits 0.

Matrix products run in full float32: ``serve`` turns TF32 off for CUDA
matmuls and cuDNN (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set to False).

Run: PYTHONPATH=src python -m repro_torch.launch.serve [--requests 64]
     [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import signal
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.core import costs, interestingness, placement, shp, tiers
from repro_torch.data.curation import TopKCurator
from repro_torch.models import lm


def make_tenant_engine(tenants: int, requests: int, topk: int, doc_gb: float,
                       device=None, obs=None, mesh=None):
    """Heterogeneous per-tenant retention: K alternates, cost models jitter
    the HBM presets, every third tenant gets a 3-tier HBM → DRAM → disk
    topology, and the fleet planner picks each tenant's boundary vector."""
    from repro_torch.core import topology
    from repro_torch.streams import StreamEngine, StreamSpec
    # ceil: when tenants doesn't divide requests, the first tenants get one
    # extra doc — the cost model must cover their longer stream
    n_per = -(-requests // tenants)
    if requests // tenants < 2:
        raise ValueError(f"need requests >= 2*tenants, got {requests} "
                         f"requests for {tenants} tenants")
    specs = []
    for t in range(tenants):
        k = max(1, min(topk if t % 2 == 0 else topk // 2, n_per - 1))
        window = 30.0 * (1 + t % 4)
        if t % 3 == 2:
            cm = topology.hbm_dram_disk_preset(
                n_docs=n_per, k=k, doc_gb=doc_gb, window_seconds=window)
        else:
            cm = costs.hbm_host_preset(n_docs=n_per, k=k, doc_gb=doc_gb,
                                       window_seconds=window)
        specs.append(StreamSpec(stream_id=t, k=k, cost_model=cm))
    return StreamEngine(specs, device=device, obs=obs, mesh=mesh), specs


def request_log_plan(requests: int, topk: int, doc_gb: float):
    """The proactive SHP plan of the single-tenant request log."""
    cm = costs.hbm_host_preset(n_docs=requests, k=topk, doc_gb=doc_gb,
                               window_seconds=60.0)
    return shp.plan_placement(cm)


@dataclass
class Batch:
    """One served batch: generated tokens (b, gen_len), mean entropy scores
    (b,), with the host-clock seconds of prefill and of the decode loop
    (each ending in a device sync), and the logits of every step when
    kept (prefill first)."""

    tokens: torch.Tensor
    scores: torch.Tensor
    prefill_s: float
    decode_s: float
    logits: Optional[List[torch.Tensor]] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg, prompts: torch.Tensor, gen_len: int, *,
             use_kernel: bool = True, forced: Optional[torch.Tensor] = None,
             keep_logits: bool = False) -> Batch:
    """Prefill ``prompts`` (b, prompt_len), then ``gen_len - 1`` greedy
    decode steps. Each request's score is the mean over the decode steps of
    the predictive entropy of that step's logits; the first token, from the
    prefill logits, is not scored. Greedy argmax takes the first maximum.

    ``use_kernel=False`` runs the plain versions (grouped attention in
    prefill, the −Σp·log p entropy) on any device. ``forced`` (b, gen_len)
    teacher-forces the decode: step t is fed ``forced[:, t]`` in place of
    the argmax, which is still what ``tokens`` returns."""
    b, s = prompts.shape
    dev = prompts.device
    t0 = time.perf_counter()
    cache = lm.init_cache(cfg, b, s + gen_len + 1, device=dev)
    logits, cache = lm.prefill(params, cfg, {"tokens": prompts}, cache,
                               use_kernel=use_kernel)
    toks = [torch.argmax(logits, -1)]
    kept = [logits] if keep_logits else None
    _sync(dev)
    t1 = time.perf_counter()
    ent_sum = torch.zeros((b,), dtype=torch.float32, device=dev)
    for t in range(gen_len - 1):
        feed = toks[-1] if forced is None else forced[:, t]
        logits, cache = lm.decode_step(params, cfg, feed, cache)
        ent_sum += interestingness.entropy_score(logits[:, None],
                                                 use_kernel=use_kernel)
        toks.append(torch.argmax(logits, -1))
        if keep_logits:
            kept.append(logits)
    scores = ent_sum / (gen_len - 1)
    _sync(dev)
    return Batch(tokens=torch.stack(toks, 1), scores=scores, prefill_s=t1 - t0,
                 decode_s=time.perf_counter() - t1, logits=kept)


@dataclass
class ServeResult:
    """What ``serve`` did: per request (in id order) the score and the
    generated tokens; the retention side (``curator`` and ``store``, or
    ``engine`` with its tenant ``specs``); ``retained``: the single-tenant
    curator's top-K ids (their payloads not yet read:
    ``curator.finalize()`` reads them), or each tenant's surviving
    per-tenant doc indices; and per batch the prefill and decode
    seconds."""

    scores: np.ndarray
    tokens: np.ndarray
    retained: object
    curator: Optional[TopKCurator] = None
    store: Optional[tiers.TieredStore] = None
    engine: object = None
    specs: list = field(default_factory=list)
    prefill_s: List[float] = field(default_factory=list)
    decode_s: List[float] = field(default_factory=list)
    seconds: float = 0.0
    tokens_per_s: float = 0.0
    reconcile: Dict = field(default_factory=dict)
    final_checkpoint: Optional[Dict] = None


def _hold(seconds: float, stop) -> None:
    """Sleep ``seconds``, in short naps that end early once ``stop()``."""
    until = time.perf_counter() + seconds
    while time.perf_counter() < until and not (stop is not None and stop()):
        time.sleep(min(0.1, until - time.perf_counter()))


def serve(cfg, params, *, requests: int, batch: int, prompt_len: int,
          gen_len: int, topk: int, tenants: int = 1, device=None,
          seed: int = 0, obs=None, hold_s: float = 0.0,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 4,
          stop=None, mesh=None, engine=None, specs=None) -> ServeResult:
    """Serve ``requests`` requests in batches of ``batch`` (random prompts
    of ``prompt_len`` tokens from ``np.random.default_rng(seed)``, as the
    reference's example draws them), generate ``gen_len`` tokens each,
    score them and retain the top ``topk`` across tiers. ``params`` live
    on ``device`` (the CUDA card unless given). ``obs`` (a
    ``repro_torch.obs.Observability``) observes the tenant engine;
    ``hold_s`` stretches the loop over at least that many seconds (a
    pause after each batch).

    ``ckpt_dir`` (tenants > 1) attaches a ``resilience.FleetCheckpointer``
    that checkpoints the tenant engine every ``ckpt_every`` chunks (0:
    only the final one) and, when the loop ends, writes a final blocking
    checkpoint before ``finalize`` (``final_checkpoint`` holds its
    generation and chunk). ``stop`` (a callable) is asked before each
    batch: once it returns true the loop ends, the batch in flight
    having finished. ``mesh`` (a ``parallel.fleet.FleetMesh``, tenants >
    1) shards the tenant engine. ``engine`` and ``specs`` (tenants > 1)
    are a tenant engine and its specs from ``make_tenant_engine``, built
    here when not given."""
    dev = device_mod.resolve(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    doc_gb = (prompt_len + gen_len) * 4 / 1e9
    curator = store = None
    if tenants > 1:
        if engine is None:
            engine, specs = make_tenant_engine(tenants, requests, topk,
                                               doc_gb, device=dev, obs=obs,
                                               mesh=mesh)
    else:
        engine, specs = None, []
        # proactive placement for the request-log stream
        pol = placement.from_plan(request_log_plan(requests, topk, doc_gb))
        store = tiers.TieredStore(
            pol, tiers.HotTier(topk, (prompt_len + gen_len,),
                               dtype=torch.int32, device=dev),
            tiers.ColdTier())
        curator = TopKCurator(topk, store, policy=pol)
    checkpointer = None
    if ckpt_dir is not None:
        if engine is None:
            raise ValueError("ckpt_dir needs tenants > 1")
        from repro_torch.resilience import FleetCheckpointer
        checkpointer = FleetCheckpointer(ckpt_dir, every=ckpt_every)
        engine.attach_checkpointer(checkpointer)
    rng = np.random.default_rng(seed)
    n_batches = -(-requests // batch)
    scores, tokens, pre_s, dec_s = [], [], [], []
    served = 0
    t0 = time.perf_counter()
    while served < requests and not (stop is not None and stop()):
        b = min(batch, requests - served)
        prompts = rng.integers(0, cfg.vocab_size, (b, prompt_len))
        out = generate(params, cfg, torch.as_tensor(prompts, device=dev),
                       gen_len)
        sc = out.scores.cpu().numpy()
        gen = out.tokens.cpu().numpy()
        ids = np.arange(served, served + b)
        if engine is not None:
            # interleave requests across tenants; doc index is per-tenant
            engine.ingest(ids % tenants, sc, ids // tenants)
        else:
            curator.observe_batch(ids, sc,
                                  np.concatenate([prompts, gen], axis=1))
        scores.append(sc)
        tokens.append(gen)
        pre_s.append(out.prefill_s)
        dec_s.append(out.decode_s)
        served += b
        if hold_s > 0:
            _hold(hold_s / n_batches, stop)
    dt = time.perf_counter() - t0
    res = ServeResult(scores=(np.concatenate(scores) if scores
                              else np.empty(0, np.float32)),
                      tokens=(np.concatenate(tokens) if tokens
                              else np.empty((0, gen_len), np.int64)),
                      retained=None,
                      curator=curator, store=store, engine=engine,
                      specs=specs, prefill_s=pre_s, decode_s=dec_s,
                      seconds=dt,
                      tokens_per_s=served * (prompt_len + gen_len) / dt)
    if checkpointer is not None:
        gen = checkpointer.save(engine, blocking=True)
        res.final_checkpoint = {"generation": gen,
                                "chunk": int(engine.chunks_ingested)}
    if engine is not None:
        res.retained = engine.finalize()
        res.reconcile = engine.meter.reconcile(batch=max(1, batch // tenants))
    else:
        res.retained = curator.survivor_ids().tolist()
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--full", action="store_true",
                    help="serve the architecture at its full width (the "
                         "default is its reduced config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--topk", type=int, default=8)
    ap.add_argument("--tenants", type=int, default=1,
                    help="number of tenant streams; with >1, retention is "
                         "routed through the multi-tenant streams engine "
                         "(heterogeneous per-tenant K, cost model and tier "
                         "depth); requires --requests >= 2*tenants")
    ap.add_argument("--obs-out", default=None, metavar="DIR",
                    help="enable the repro_torch.obs telemetry layer and "
                         "write metrics.json / metrics.prom (Prometheus "
                         "text exposition) / events.jsonl to DIR")
    ap.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                    help="serve live /metrics (Prometheus) and /snapshot "
                         "(JSON) from the running engine on 127.0.0.1 at "
                         "this port (0 = ephemeral); implies the obs layer "
                         "with cost attribution on")
    ap.add_argument("--obs-hold", type=float, default=0.0, metavar="SEC",
                    help="stretch the serving loop over at least SEC "
                         "seconds so a scraper can observe the live "
                         "counters advancing")
    ap.add_argument("--mesh", type=int, default=1,
                    help="shard the tenant fleet axis over N shards: N "
                         "cards when N are visible, else N shards on the "
                         "engine's device; requires --tenants > 1")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="crash-consistent fleet checkpointing "
                         "(repro_torch.resilience; requires --tenants > "
                         "1): write chunk-boundary checkpoints to DIR, "
                         "plus a final blocking checkpoint on exit and on "
                         "SIGTERM/SIGINT")
    ap.add_argument("--ckpt-every", type=int, default=4, metavar="N",
                    help="checkpoint every N ingested chunks (0 = final "
                         "checkpoint only)")
    return ap.parse_args(argv)


def check_flags(args) -> None:
    """Exits on flags that need ``--tenants > 1``."""
    if args.mesh > 1 and args.tenants <= 1:
        raise SystemExit("--mesh requires --tenants > 1")
    if args.ckpt_dir is not None and args.tenants <= 1:
        raise SystemExit("--ckpt-dir requires --tenants > 1")


def setup(args, dev):
    """The fleet mesh (``--mesh``), the obs layer (``--obs-out`` /
    ``--obs-port``) and its endpoint, each startup line printed: (mesh,
    obs, obs_server), None where not asked for."""
    mesh = None
    if args.mesh > 1:
        from repro_torch.parallel import fleet
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if cards >= args.mesh:
            mesh = fleet.fleet_mesh(args.mesh)
            where = f"{args.mesh} cards"
        else:
            mesh = fleet.fleet_mesh(args.mesh, device=dev)
            where = f"{mesh.devices[0]} ({cards} cards visible)"
        print(f"fleet mesh: {args.mesh} shards on {where}, tenant axis "
              "sharded", flush=True)
    obs = obs_server = None
    if args.obs_out is not None or args.obs_port is not None:
        from repro_torch.obs import Observability, ObsConfig
        # the live dashboard prices the fleet as it serves — cost
        # attribution rides along whenever the endpoint is requested
        obs = Observability(ObsConfig(costs=args.obs_port is not None))
    if args.obs_port is not None:
        from repro_torch.obs import http as obs_http
        obs_server = obs_http.serve(obs, port=args.obs_port)
        print(f"obs endpoint: {obs_server.url}/metrics "
              f"{obs_server.url}/snapshot", flush=True)
    return mesh, obs, obs_server


@contextlib.contextmanager
def graceful_stop(obs_server=None):
    """SIGTERM and SIGINT only request a stop: yields a dict whose
    ``"signal"`` the handler sets, so that the loop finishes its batch in
    flight and the normal teardown runs (final blocking checkpoint, obs
    artifacts). On exit the previous handlers come back and
    ``obs_server`` is stopped."""
    stop = {"signal": None}

    def _request_stop(signum, frame):
        stop["signal"] = signum

    previous = {s: signal.signal(s, _request_stop)
                for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield stop
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
        if obs_server is not None:
            obs_server.stop()


def main(argv=None):
    args = parse_args(argv)
    check_flags(args)
    dev = device_mod.resolve(args.device)
    mesh, obs, obs_server = setup(args, dev)
    with graceful_stop(obs_server) as stop:
        _serve_and_report(args, dev, obs, stop, mesh)


def _serve_and_report(args, dev, obs, stop, mesh) -> None:
    cfg = configs.get_config(args.arch, reduced=not args.full)
    params = lm.init_params(cfg, seed=0, device=dev)
    print(f"serving {'full' if args.full else 'reduced'} {args.arch} on "
          f"{dev}: vocab={cfg.vocab_size}, {lm.param_count(cfg)} parameters")
    if args.ckpt_dir is not None:
        print(f"checkpointing to {args.ckpt_dir} "
              f"(every {args.ckpt_every} chunks)", flush=True)
    res = serve(cfg, params, requests=args.requests, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                topk=args.topk, tenants=args.tenants, device=dev, obs=obs,
                hold_s=args.obs_hold, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every,
                stop=lambda: stop["signal"] is not None, mesh=mesh)
    report(args, res, obs, stop)


def report(args, res: ServeResult, obs, stop) -> None:
    """The lines printed after serving: the shutdown signal if one came,
    the throughput, the final checkpoint, the tenant ledgers or the
    curator's, and the obs artifacts written to ``--obs-out``."""
    served = len(res.scores)
    if stop["signal"] is not None:
        print(f"graceful shutdown on {signal.Signals(stop['signal']).name}: "
              f"served {served}/{args.requests} requests", flush=True)
    print(f"served {served} requests in {res.seconds:.1f}s "
          f"({res.tokens_per_s:.0f} tok/s)")
    if res.final_checkpoint is not None:
        print(f"final checkpoint: generation "
              f"{res.final_checkpoint['generation']} at chunk "
              f"{res.final_checkpoint['chunk']} -> {args.ckpt_dir}",
              flush=True)
    if res.engine is not None:
        rec = res.reconcile
        print(f"fleet ledger: writes actual={rec['fleet_actual']:.0f} "
              f"expected={rec['fleet_expected']:.1f} "
              f"mean rel err={rec['mean_rel_err']:+.2%}")
        hist = res.engine.plan.strategy_histogram()
        print("per-stream strategies: "
              + ", ".join(f"{s}={c}" for s, c in sorted(hist.items())))
        if obs is not None and obs.config.costs:
            summ = res.engine.cost_summary()
            print(f"cost attribution: realized={summ['total'].sum():.3e} "
                  f"planned={summ['planned'].sum():.3e} "
                  f"regret={summ['regret'].sum():+.3e}")
        for t in sorted(res.retained)[:4]:
            reqs = (np.asarray(res.retained[t]) * args.tenants + t).tolist()
            print(f"tenant {t}: top-{res.specs[t].k} retained requests "
                  f"{reqs}")
        if args.tenants > 4:
            print(f"... ({args.tenants - 4} more tenants)")
    else:
        print(f"curation: {res.curator.stats.as_dict()}")
        print(f"ledger: {res.store.ledger.as_dict()}")
        retained = res.curator.finalize()
        print(f"top-{args.topk} most-uncertain requests retained for review: "
              f"{sorted(retained)}")
    if obs is not None and args.obs_out is not None:
        paths = obs.write(args.obs_out)
        probes = obs.snapshot().get("jit", {})
        print("obs: " + ", ".join(
            f"{name} calls={p['calls']} misses={p['misses']}"
            for name, p in sorted(probes.items())) if probes else
            "obs: no compile-cache probe fired")
        print("obs artifacts: " + ", ".join(sorted(paths.values())))


if __name__ == "__main__":
    main()
