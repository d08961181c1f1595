"""The port's serve loop (``repro_torch.launch.serve``) against the
reference's — ``lm.prefill`` / ``lm.decode_step`` driven as
examples/serve_topk.py drives them, with its ``make_tenant_engine`` — at
reduced size with the reference's weights carried across: generated
tokens equal, scores within tolerance, the curator's ledger and retained
ids equal single-tenant, and with tenants=3 the engine's survivors and
meter reconciliation equal. Plus HotTier / TieredStore / TopKCurator and
``hbm_dram_disk_preset`` against the originals.

Tolerance: scores (mean entropies) within 2e-5 (the port's kernel route
takes entropy as lse − Σe·l/Σe, the reference −Σp·log p, after logits
that agree to ~1e-6). Retention is exact, which holds only when no two
scores lie within that tolerance of each other: a near-tie could flip a
write. Each retention test asserts that no such near-tie exists in its
scores before it compares ledgers and retained ids.
"""
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.core import costs as r_costs
from repro.core import placement as r_place
from repro.core import shp as r_shp
from repro.core import tiers as r_tiers
from repro.core import topology as r_topo
from repro.data import curation as r_cur
from repro.models import lm as r_lm
from repro_torch import configs as t_configs
from repro_torch.core import placement as t_place
from repro_torch.core import tiers as t_tiers
from repro_torch.core import topology as t_topo
from repro_torch.data import curation as t_cur
from repro_torch.launch import serve as t_serve
from repro_torch.models import lm as t_lm

TOL = 2e-5
ROOT = Path(__file__).resolve().parents[1]
RUN = dict(requests=24, batch=8, prompt_len=8, gen_len=6, topk=8)


@pytest.fixture(scope="module")
def example():
    """examples/serve_topk.py as a module (its main() does not run)."""
    spec = importlib.util.spec_from_file_location(
        "serve_topk_example", ROOT / "examples" / "serve_topk.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def model():
    cfg = r_configs.get_config("llama3.2-1b", reduced=True)
    params = r_lm.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = t_configs.get_config("llama3.2-1b", reduced=True)
    tparams = t_lm.from_reference_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def starcoder():
    """Reduced starcoder2-3b (LayerNorm, GELU, qkv and FFN biases, tied
    embeddings, a sliding window of 8) with the reference's weights."""
    cfg = r_configs.get_config("starcoder2-3b", reduced=True)
    params = r_lm.init_params(cfg, jax.random.PRNGKey(1))
    tcfg = t_configs.get_config("starcoder2-3b", reduced=True)
    tparams = t_lm.from_reference_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture(scope="module", params=["mamba2-2.7b", "hymba-1.5b"])
def ssm_family(request):
    """Reduced mamba2-2.7b (two SSD layers, chunk 16) and hymba-1.5b (a
    global and a window-8 attn_ssm_parallel layer, SiLU-GLU FFN) with the
    reference's weights. The seed is one whose 24 scores hold no pair
    within the score tolerance (assert_no_near_tie)."""
    cfg = r_configs.get_config(request.param, reduced=True)
    params = r_lm.init_params(cfg, jax.random.PRNGKey(3))
    tcfg = t_configs.get_config(request.param, reduced=True)
    tparams = t_lm.from_reference_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def moe():
    """Reduced grok-1-314b (two attn + MoE layers: 4 experts, top-2, groups
    of 16, dropless; both soft-caps at 30) with the reference's weights.
    Prefill routes the batch's 64 prompt tokens in 4 groups, each decode
    step its 8 tokens in one group."""
    cfg = r_configs.get_config("grok-1-314b", reduced=True)
    params = r_lm.init_params(cfg, jax.random.PRNGKey(3))
    tcfg = t_configs.get_config("grok-1-314b", reduced=True)
    tparams = t_lm.from_reference_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def mla():
    """Reduced deepseek-v2-236b (MLA attention: 4 heads, kv_lora 16, q_lora
    24, q/k head dim 16 + 8, v head dim 16; a dense layer, then two MoE
    layers of 8 experts, top-2, with a shared expert) with the reference's
    weights. Prefill attends on the kernel's plain version at head dims
    (24, 16); each decode step is the absorbed form over the latent
    cache."""
    cfg = r_configs.get_config("deepseek-v2-236b", reduced=True)
    params = r_lm.init_params(cfg, jax.random.PRNGKey(3))
    tcfg = t_configs.get_config("deepseek-v2-236b", reduced=True)
    tparams = t_lm.from_reference_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture(autouse=True)
def numpy_reference_planner():
    prev = r_shp.set_planner_backend("numpy")
    yield
    r_shp.set_planner_backend(prev)


def reference_serve(example, cfg, params, *, requests, batch, prompt_len,
                    gen_len, topk, tenants=1):
    """examples/serve_topk.py's loop (:194-216) and retention set-up."""
    doc_gb = (prompt_len + gen_len) * 4 / 1e9
    curator = store = engine = None
    if tenants > 1:
        engine, _ = example.make_tenant_engine(tenants, requests, topk,
                                               doc_gb)
    else:
        cm = r_costs.hbm_host_preset(n_docs=requests, k=topk, doc_gb=doc_gb,
                                     window_seconds=60.0)
        pol = r_place.from_plan(r_shp.plan_placement(cm))
        store = r_tiers.TieredStore(
            pol, r_tiers.HotTier(topk, (prompt_len + gen_len,),
                                 dtype=jnp.int32), r_tiers.ColdTier())
        curator = r_cur.TopKCurator(topk, store, policy=pol)
    prefill = jax.jit(lambda p, b, c: r_lm.prefill(p, cfg, b, c))
    step = jax.jit(lambda p, t, c: r_lm.decode_step(p, cfg, t, c))
    rng = np.random.default_rng(0)
    served, all_scores, all_tokens = 0, [], []
    while served < requests:
        b = min(batch, requests - served)
        prompts = rng.integers(0, cfg.vocab_size, (b, prompt_len))
        cache = r_lm.init_cache(cfg, b, prompt_len + gen_len + 1)
        logits, cache = prefill(params,
                                {"tokens": jnp.asarray(prompts, jnp.int32)},
                                cache)
        toks = [jnp.argmax(logits, -1)]
        ent_sum = jnp.zeros((b,), jnp.float32)
        for _ in range(gen_len - 1):
            logits, cache = step(params, toks[-1], cache)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
            ent_sum += -jnp.sum(jnp.exp(logp) * logp, -1)
            toks.append(jnp.argmax(logits, -1))
        gen = jnp.stack(toks, 1)
        scores = np.asarray(ent_sum / (gen_len - 1))
        ids = np.arange(served, served + b)
        if engine is not None:
            engine.ingest(ids % tenants, scores, ids // tenants)
        else:
            payloads = np.concatenate([prompts, np.asarray(gen)], axis=1)
            curator.observe_batch(ids, scores, payloads)
        all_scores.append(scores)
        all_tokens.append(np.asarray(gen))
        served += b
    return (np.concatenate(all_scores), np.concatenate(all_tokens), curator,
            store, engine)


def assert_no_near_tie(scores):
    """Exact retention needs every pair of scores apart by more than the
    score tolerance (twice it: each side may move by TOL)."""
    gaps = np.diff(np.sort(scores.astype(np.float64)))
    assert gaps.min() > 2 * TOL, (
        f"a near-tie ({gaps.min():.3g}) within the score tolerance: "
        f"retention may differ legitimately")


def assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            assert_same(a[key], b[key])
    else:
        np.testing.assert_array_equal(a, b)


def test_serve_single_tenant_matches_reference(example, model):
    cfg, params, tcfg, tparams = model
    r_scores, r_tokens, r_curator, r_store, _ = reference_serve(
        example, cfg, params, **RUN)
    res = t_serve.serve(tcfg, tparams, tenants=1, device="cpu", **RUN)
    np.testing.assert_array_equal(res.tokens, r_tokens)
    np.testing.assert_allclose(res.scores, r_scores, rtol=TOL, atol=TOL)
    assert_no_near_tie(r_scores)
    assert res.curator.stats.as_dict() == r_curator.stats.as_dict()
    assert res.store.ledger.as_dict() == r_store.ledger.as_dict()
    retained, ours = r_curator.finalize(), res.curator.finalize()
    assert res.retained == sorted(retained) == sorted(ours)
    assert res.store.ledger.as_dict() == r_store.ledger.as_dict()
    for d in retained:
        np.testing.assert_array_equal(ours[d].cpu().numpy()
                                      if isinstance(ours[d], torch.Tensor)
                                      else ours[d], np.asarray(retained[d]))
    # the retained set is the top-K of the scores, ties to the lower id
    want = np.lexsort((np.arange(len(r_scores)), -r_scores))[:RUN["topk"]]
    assert res.retained == sorted(want.tolist())


def test_serve_starcoder2_reduced_matches_reference(example, starcoder):
    """The serve loop on the family chip_smoke.py serves at full width as
    starcoder2-3b: the 14-token requests run past the window of 8, so
    decode reads a rolling cache; tokens equal, scores within 2e-5,
    curation and retention equal."""
    cfg, params, tcfg, tparams = starcoder
    assert cfg.layers[0].windows[0] < RUN["prompt_len"] + RUN["gen_len"]
    r_scores, r_tokens, r_curator, r_store, _ = reference_serve(
        example, cfg, params, **RUN)
    res = t_serve.serve(tcfg, tparams, tenants=1, device="cpu", **RUN)
    np.testing.assert_array_equal(res.tokens, r_tokens)
    np.testing.assert_allclose(res.scores, r_scores, rtol=TOL, atol=TOL)
    assert_no_near_tie(r_scores)
    assert res.curator.stats.as_dict() == r_curator.stats.as_dict()
    assert res.store.ledger.as_dict() == r_store.ledger.as_dict()
    retained, ours = r_curator.finalize(), res.curator.finalize()
    assert res.retained == sorted(retained) == sorted(ours)
    for d in retained:
        np.testing.assert_array_equal(ours[d].numpy(), np.asarray(retained[d]))


def test_serve_ssm_and_hybrid_reduced_match_reference(example, ssm_family):
    """The serve loop on the families chip_smoke.py serves at full width
    as mamba2-2.7b and hymba-1.5b: the 8-token prompts fill half a chunk
    of 16 (a padded scan), decode carries the SSM and conv states, and
    hymba's window-8 layer reads a rolling cache; tokens equal, scores
    within 2e-5, curation and retention equal, the retained set the
    top-K of the scores."""
    cfg, params, tcfg, tparams = ssm_family
    r_scores, r_tokens, r_curator, r_store, _ = reference_serve(
        example, cfg, params, **RUN)
    res = t_serve.serve(tcfg, tparams, tenants=1, device="cpu", **RUN)
    np.testing.assert_array_equal(res.tokens, r_tokens)
    np.testing.assert_allclose(res.scores, r_scores, rtol=TOL, atol=TOL)
    assert_no_near_tie(r_scores)
    assert res.curator.stats.as_dict() == r_curator.stats.as_dict()
    assert res.store.ledger.as_dict() == r_store.ledger.as_dict()
    retained, ours = r_curator.finalize(), res.curator.finalize()
    assert res.retained == sorted(retained) == sorted(ours)
    for d in retained:
        np.testing.assert_array_equal(ours[d].numpy(), np.asarray(retained[d]))
    want = np.lexsort((np.arange(len(r_scores)), -r_scores))[:RUN["topk"]]
    assert res.retained == sorted(want.tolist())


def test_serve_moe_reduced_matches_reference(example, moe):
    """The serve loop on the family chip_smoke.py serves at full width as
    grok-1-314b (soft-capped attention, MoE FFNs, a soft-capped head):
    tokens equal, scores within 2e-5, curation and retention equal, the
    retained set the top-K of the scores."""
    cfg, params, tcfg, tparams = moe
    r_scores, r_tokens, r_curator, r_store, _ = reference_serve(
        example, cfg, params, **RUN)
    res = t_serve.serve(tcfg, tparams, tenants=1, device="cpu", **RUN)
    np.testing.assert_array_equal(res.tokens, r_tokens)
    np.testing.assert_allclose(res.scores, r_scores, rtol=TOL, atol=TOL)
    assert_no_near_tie(r_scores)
    assert res.curator.stats.as_dict() == r_curator.stats.as_dict()
    assert res.store.ledger.as_dict() == r_store.ledger.as_dict()
    retained, ours = r_curator.finalize(), res.curator.finalize()
    assert res.retained == sorted(retained) == sorted(ours)
    for d in retained:
        np.testing.assert_array_equal(ours[d].numpy(), np.asarray(retained[d]))
    want = np.lexsort((np.arange(len(r_scores)), -r_scores))[:RUN["topk"]]
    assert res.retained == sorted(want.tolist())


def test_serve_tenants_matches_reference(example, model):
    cfg, params, tcfg, tparams = model
    _, _, _, _, r_engine = reference_serve(example, cfg, params, tenants=3,
                                           **RUN)
    res = t_serve.serve(tcfg, tparams, tenants=3, device="cpu", **RUN)
    assert_no_near_tie(res.scores)
    r_surv = r_engine.finalize()
    assert r_surv.keys() == res.retained.keys()
    for t in r_surv:
        np.testing.assert_array_equal(res.retained[t], r_surv[t])
    assert_same(res.reconcile, r_engine.meter.reconcile(batch=8 // 3))
    assert [s.k for s in res.specs] == [7, 4, 7]


def test_kernel_route_equals_plain_route_on_cpu(model):
    """use_kernel=False (grouped attention, −Σp·log p) against the default
    route, teacher-forced on the default route's tokens."""
    _, _, tcfg, tparams = model
    prompts = torch.tensor(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (4, 12)))
    a = t_serve.generate(tparams, tcfg, prompts, 7, keep_logits=True)
    b = t_serve.generate(tparams, tcfg, prompts, 7, use_kernel=False,
                         forced=a.tokens, keep_logits=True)
    torch.testing.assert_close(a.scores, b.scores, rtol=TOL, atol=TOL)
    for x, y in zip(a.logits, b.logits):
        torch.testing.assert_close(x, y, rtol=TOL, atol=TOL)
    assert torch.equal(a.tokens, b.tokens)
    assert a.tokens.shape == (4, 7) and len(a.logits) == 7


def test_cli_flags_not_ported_raise():
    """Every flag is ported; ``--mesh`` with one tenant exits with the
    reference's message (examples/serve_topk.py) before anything runs
    (``--mesh 2 --tenants 4`` runs: tests/test_torch_parallel.py)."""
    with pytest.raises(SystemExit, match=r"--mesh requires --tenants > 1"):
        t_serve.main(["--mesh", "2", "--device", "cpu"])


def test_cli_ckpt_dir_needs_tenants(tmp_path):
    """``--ckpt-dir`` with one tenant exits with the reference's message
    (examples/serve_topk.py), before anything is built or written."""
    with pytest.raises(SystemExit, match=r"--ckpt-dir requires --tenants > 1"):
        t_serve.main(["--device", "cpu", "--tenants", "1", "--ckpt-dir",
                      str(tmp_path / "ckpt")])
    assert not (tmp_path / "ckpt").exists()


def test_cli_sigterm_drains_and_checkpoints(tmp_path):
    """tests/test_shutdown.py against the port's launcher: SIGTERM after
    the first checkpoint finishes the batch in flight, writes a final
    blocking checkpoint at the ingest cursor, flushes the obs artifacts
    and exits 0; the final checkpoint restores into a fresh tenant engine
    with the printed cursor."""
    from repro_torch.obs import Observability, ObsConfig
    from repro_torch.resilience import FleetCheckpointer
    ckpt, obs = tmp_path / "ckpt", tmp_path / "obs"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--tenants", "2", "--requests", "32", "--batch", "4",
         "--ckpt-dir", str(ckpt), "--ckpt-every", "1", "--obs-out", str(obs),
         "--obs-hold", "120"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            if ckpt.is_dir() and any(d.startswith("ckpt_")
                                     for d in os.listdir(ckpt)):
                break
            if proc.poll() is not None:
                pytest.fail("server exited early:\n"
                            + proc.communicate()[0][-2000:])
            time.sleep(0.2)
        else:
            pytest.fail("no checkpoint appeared before the deadline")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=40)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-2000:]
    assert "graceful shutdown on SIGTERM" in out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("final checkpoint: generation"))
    chunk = int(line.split(" at chunk ")[1].split()[0])
    assert 1 <= chunk < 8  # stopped early: 8 batches of 4 requests
    assert (obs / "metrics.json").exists(), out[-2000:]
    # the launcher's tenant engine: --obs-out turns obs on (no costs)
    eng, _ = t_serve.make_tenant_engine(2, 32, 8, (16 + 12) * 4 / 1e9,
                                        device="cpu",
                                        obs=Observability(ObsConfig()))
    FleetCheckpointer(str(ckpt)).restore(eng)
    assert eng.chunks_ingested == chunk


SERVE_ARGV = ["--device", "cpu", "--requests", "12", "--batch", "4",
              "--gen-len", "3", "--prompt-len", "4", "--tenants", "2"]


def test_cli_obs_out_writes_artifacts(tmp_path, capsys):
    """``--obs-out`` (reduced llama3.2-1b, two tenants) writes
    metrics.json, metrics.prom and events.jsonl: the engine's counters
    cover every served request, one ingest span a batch."""
    t_serve.main(SERVE_ARGV + ["--obs-out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "obs artifacts:" in out
    assert sorted(os.listdir(tmp_path)) == ["events.jsonl", "metrics.json",
                                            "metrics.prom"]
    snap = json.load(open(tmp_path / "metrics.json"))
    eng = snap["engines"]["engine0"]
    assert eng["engine"]["docs"] == eng["meter"]["observed"] == 12
    assert eng["engine"]["chunks"] == 3
    names = [json.loads(line)["name"]
             for line in open(tmp_path / "events.jsonl")]
    assert names == ["plan"] + ["ingest"] * 3 + ["finalize"]
    prom = open(tmp_path / "metrics.prom").read()
    assert "# TYPE repro_obs_engines_engine0_engine_docs counter" in prom


def _scrape(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        text = r.read().decode()
    counters = {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE") and line.endswith(" counter")}
    values = {}
    for line in text.splitlines():
        if not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            if name.split("{")[0] in counters:
                values[name] = float(value)
    return values


def test_cli_obs_port_serves_monotone_counters():
    """``--obs-port 0`` serves /metrics on 127.0.0.1 from the running
    launcher (cost attribution on); two scrapes a second apart while
    ``--obs-hold`` stretches the loop give typed counters that never
    decrease."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *SERVE_ARGV,
         "--requests", "24", "--obs-port", "0", "--obs-hold", "12"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")})
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("obs endpoint:"):
                url = line.split()[2]
                break
        assert url is not None and url.startswith("http://127.0.0.1:")
        scrapes = []
        while len(scrapes) < 2:
            values = _scrape(url)
            if any(k.endswith("engine_docs") for k in values):
                scrapes.append(values)
            time.sleep(1.0)
        rest = proc.communicate(timeout=120)[0]
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, rest
    assert "cost attribution: realized=" in rest
    first, second = scrapes
    assert first.keys() <= second.keys()
    assert all(second[k] >= first[k] for k in first)
    assert any(k.endswith("costs_device_resident_steps") for k in first)


def test_serve_mla_reduced_matches_reference(example, mla):
    """The serve loop on the family chip_smoke.py serves at full width as
    deepseek-v2-236b (MLA: the expanded prefill and the latent cache's
    absorbed decode; MoE FFNs with a shared expert): tokens equal, scores
    within 2e-5, curation and retention equal, the retained set the top-K
    of the scores."""
    cfg, params, tcfg, tparams = mla
    r_scores, r_tokens, r_curator, r_store, _ = reference_serve(
        example, cfg, params, **RUN)
    res = t_serve.serve(tcfg, tparams, tenants=1, device="cpu", **RUN)
    np.testing.assert_array_equal(res.tokens, r_tokens)
    np.testing.assert_allclose(res.scores, r_scores, rtol=TOL, atol=TOL)
    assert_no_near_tie(r_scores)
    assert res.curator.stats.as_dict() == r_curator.stats.as_dict()
    assert res.store.ledger.as_dict() == r_store.ledger.as_dict()
    retained, ours = r_curator.finalize(), res.curator.finalize()
    assert res.retained == sorted(retained) == sorted(ours)
    for d in retained:
        np.testing.assert_array_equal(ours[d].numpy(), np.asarray(retained[d]))
    want = np.lexsort((np.arange(len(r_scores)), -r_scores))[:RUN["topk"]]
    assert res.retained == sorted(want.tolist())


def test_cli_serves_deepseek_on_cpu(capsys):
    """``--arch deepseek-v2-236b`` (the reduced MLA model) runs through the
    launcher's existing flags."""
    t_serve.main(["--device", "cpu", "--arch", "deepseek-v2-236b",
                  "--requests", "12", "--gen-len", "3", "--prompt-len", "4"])
    out = capsys.readouterr().out
    assert "serving reduced deepseek-v2-236b on cpu" in out
    assert "served 12 requests" in out


def test_cli_serves_on_cpu(capsys):
    t_serve.main(["--device", "cpu", "--requests", "12", "--gen-len", "3",
                  "--prompt-len", "4", "--tenants", "2"])
    out = capsys.readouterr().out
    assert "served 12 requests" in out and "tenant 1: top-4" in out


def test_cli_serves_grok_on_cpu(capsys):
    """``--arch grok-1-314b`` (the reduced MoE with soft-capping) runs
    through the launcher's existing flags."""
    t_serve.main(["--device", "cpu", "--arch", "grok-1-314b", "--requests",
                  "12", "--gen-len", "3", "--prompt-len", "4"])
    out = capsys.readouterr().out
    assert "serving reduced grok-1-314b on cpu" in out
    assert "served 12 requests" in out


# ---------------------------------------------------------------------------
# the retention runtime against the originals
# ---------------------------------------------------------------------------

def policies():
    return [dict(r=5.0, migrate_at_r=True),
            dict(boundaries=(4.0, 9.0), migrate_at_r=True),
            dict(boundaries=(3.0, 3.0), migrate_at_r=True),
            dict(boundaries=(6.0, 40.0), migrate_at_r=False)]


@pytest.mark.parametrize("pol", policies())
def test_curator_and_tiered_store_match_reference(pol, tmp_path):
    rng = np.random.default_rng(11)
    n, k, width = 60, 6, 5
    scores = np.round(rng.standard_normal(n), 1)  # ties at the threshold
    payloads = rng.integers(0, 1000, (n, width))
    n_tiers = len(pol.get("boundaries", (0,))) + 1

    def build(place, tiers, cur, device_kw, spill):
        policy = place.Policy(**pol)
        stores = [tiers.HotTier(k, (width,), **device_kw), tiers.ColdTier()]
        if n_tiers == 3:
            stores.append(tiers.ColdTier(str(spill)))
        store = tiers.TieredStore(policy, *stores)
        return cur.TopKCurator(k, store, policy=policy), store

    rc, rs = build(r_place, r_tiers, r_cur, {"dtype": jnp.int32},
                   tmp_path / "ref")
    tc, ts = build(t_place, t_tiers, t_cur,
                   {"dtype": torch.int32, "device": "cpu"}, tmp_path / "port")
    for lo in range(0, n, 7):
        ids = np.arange(lo, min(lo + 7, n))[::-1]  # observe_batch sorts
        rc.observe_batch(ids, scores[ids], payloads[ids])
        tc.observe_batch(ids, scores[ids], payloads[ids])
        assert tc.stats.as_dict() == rc.stats.as_dict()
        assert ts.ledger.as_dict() == rs.ledger.as_dict()
    np.testing.assert_array_equal(tc.survivor_ids(), rc.survivor_ids())
    assert tc.threshold == rc.threshold
    assert tc.expected_writes() == rc.expected_writes()
    rf, tf = rc.finalize(), tc.finalize()
    assert rf.keys() == tf.keys()
    for d in rf:
        got = tf[d].numpy() if isinstance(tf[d], torch.Tensor) else tf[d]
        np.testing.assert_array_equal(got, np.asarray(rf[d]))
    assert ts.ledger.as_dict() == rs.ledger.as_dict()
    assert [ts.tier_index_of(int(d)) for d in rf] == \
        [rs.tier_index_of(int(d)) for d in rf]


def test_hot_tier_matches_reference():
    rh = r_tiers.HotTier(3, (4,), dtype=jnp.float32)
    th = t_tiers.HotTier(3, (4,), dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    for doc in (5, 7, 5, 9):
        p = rng.standard_normal(4).astype(np.float32)
        assert th.put(doc, p) == rh.put(doc, jnp.asarray(p))
    th.delete(7)
    rh.delete(7)
    assert sorted(th.doc_ids()) == sorted(rh.doc_ids()) == [5, 9]
    for doc in (5, 9):
        np.testing.assert_array_equal(th.get(doc).numpy(),
                                      np.asarray(rh.get(doc)))
    th.put(11, np.ones(4, np.float32))
    with pytest.raises(RuntimeError, match="full"):
        th.put(12, np.ones(4, np.float32))
    assert t_tiers.payload_nbytes(th.get(5)) == \
        r_tiers.payload_nbytes(rh.get(5)) == 16


def test_hbm_dram_disk_preset_equals_reference():
    for kw in (dict(n_docs=100, k=8, doc_gb=1e-6, window_seconds=30.0),
               dict(n_docs=7, k=3, doc_gb=4.8e-8, window_seconds=120.0,
                    hbm_capacity_docs=2.0, host_link_gbps=16.0)):
        assert repr(t_topo.hbm_dram_disk_preset(**kw)) == \
            repr(r_topo.hbm_dram_disk_preset(**kw))
