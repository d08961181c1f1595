"""repro_torch.core.shp_device, the device planner (run here on the CPU,
where ``plan_solve`` runs its plain version): against the JAX package's
``shp_jax._plan_impl`` called eagerly under ``jax.enable_x64`` through
both of its reductions (the Pallas kernel in interpret mode, and the jnp
route), against the NumPy oracle on random constrained 2-, 3- and 4-tier
fleets, and ``shp.plan_ntier_arrays``'s backend dispatch.

Tolerances are the reference's own (tests/test_plan_device.py):
float64 totals within ``F64_RTOL`` = 1e-11 relative, the infeasible set
equal with zeroed bounds, ``migrate`` equal, and bounds equal or
re-evaluating under the oracle objective to the same total within
1e-11; float32 plans re-evaluate within 1e-5 of the oracle's optimum,
with totals within 5e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constraints as j_cons
from repro.core import shp as j_shp
from repro.core import shp_jax as j_shp_jax
from repro_torch.core import constraints as t_cons
from repro_torch.core import costs as t_costs
from repro_torch.core import shp as t_shp
from repro_torch.core import shp_device as t_dev
from repro_torch.core import topology as t_topo
from repro_torch.streams import engine as t_eng
from repro_torch.streams import planner as t_planner
from test_torch_host import build_model, draw_model

T_PKG = (t_costs, t_topo, t_cons)

F64_RTOL = 1e-11


def _rand_batch(rng, m, t):
    n = rng.integers(2_000, 1_000_000, m).astype(np.float64)
    k = np.maximum(1, (n * rng.uniform(0.001, 0.1, m))).astype(np.float64)
    r = lambda s: 10.0 ** rng.uniform(-8, -3, s)  # noqa: E731
    return r((m, t)), r((m, t)), r((m, t)), n, k, np.ones(m)


def _rand_constraints(rng, m, t, k):
    cap = np.full((m, t), np.inf)
    cap[:, 0] = np.where(rng.random(m) < 0.8,
                         k * rng.uniform(0.05, 2.0, m), np.inf)
    if t > 2:
        cap[:, 1] = np.where(rng.random(m) < 0.5,
                             k * rng.uniform(0.2, 1.5, m), np.inf)
    cap[:, -1] = np.where(rng.random(m) < 0.2,
                          k * rng.uniform(0.05, 0.5, m), np.inf)
    lat = 10.0 ** rng.uniform(-3, 2, (m, t))
    lat.sort(axis=1)
    slo = np.where(rng.random(m) < 0.6,
                   10.0 ** rng.uniform(
                       np.log10(np.maximum(lat[:, 0], 1e-6)),
                       np.log10(lat[:, -1] + 1e-6)),
                   np.inf)
    return cap, lat, slo


def _eval_plan(args, bounds, mig):
    """The f64 plan objective at given (bounds, migrate) — the planner's
    conventions (most-expensive-used-tier rental / cascade fees)."""
    cw, cr, cs, n, k, rpw = args
    m, t = cw.shape
    edges = np.concatenate([np.zeros((m, 1)), bounds, n[:, None]], 1)
    w = j_shp._w_approx(edges, k[:, None])
    wseg = np.diff(w, axis=1)
    frac = np.diff(edges, axis=1) / n[:, None]
    writes = (wseg * cw).sum(1)
    reads = rpw * k * (frac * cr).sum(1)
    used = frac > 0
    tot_nm = writes + reads + k * np.max(np.where(used, cs, -np.inf), 1)
    stor_mg = k * (frac * cs).sum(1)
    fee = np.zeros(m)
    prev = np.zeros(m, np.int64)
    usedm = np.concatenate([frac[:, :-1] > 0, np.ones((m, 1), bool)], 1)
    seen = np.logical_or.accumulate(usedm, 1)[:, :-1]
    crossing = usedm[:, 1:] & seen
    rows = np.arange(m)
    for ti in range(1, t):
        hop = crossing[:, ti - 1]
        fee = fee + np.where(hop, cr[rows, prev] + cw[:, ti], 0.0)
        prev = np.where(usedm[:, ti], ti, prev)
    return np.where(mig, writes + stor_mg + k * fee, tot_nm)


def assert_f64_plan(args, ref, got):
    """The float64 rule: feasibility, zeroed infeasible bounds, totals,
    migrate, and bounds equal or as cheap under the oracle objective."""
    feas = np.isfinite(ref["total"])
    np.testing.assert_array_equal(np.isfinite(got["total"]), feas)
    assert (got["bounds"][~feas] == 0.0).all()
    np.testing.assert_allclose(got["total"][feas], ref["total"][feas],
                               rtol=F64_RTOL)
    np.testing.assert_array_equal(got["migrate"], ref["migrate"])
    same = (got["bounds"] == ref["bounds"]).all(axis=1)
    re_ev = _eval_plan(args, got["bounds"], got["migrate"])
    moved = feas & ~same
    np.testing.assert_allclose(re_ev[moved], ref["total"][moved],
                               rtol=F64_RTOL)


def assert_f32_plan(args, ref, got):
    """The float32 rule: the plan re-evaluates within 1e-5 of the
    oracle's optimum; reported totals within 5e-3."""
    np.testing.assert_allclose(got["total"], ref["total"], rtol=5e-3)
    re_ev = _eval_plan(args, got["bounds"], got["migrate"])
    np.testing.assert_allclose(re_ev, ref["total"], rtol=1e-5)


# ---------------------------------------------------------------------------
# against the reference's device planner, called eagerly
# ---------------------------------------------------------------------------

def _plan_impl(args, cap, lat, slo, use_pallas):
    """``shp_jax._plan_impl`` in float64 on jnp inputs (its public entry
    point needs the import that fails on this jax; the function itself
    runs)."""
    cw = args[0]
    m, t = cw.shape
    cap_h = np.full((m, t), np.inf) if cap is None else cap
    lat_h = np.zeros((m, t)) if lat is None else lat
    slo_h = np.full(m, np.inf) if slo is None else slo
    with jax.enable_x64(True):
        out = j_shp_jax._plan_impl(
            *(jnp.asarray(a, jnp.float64) for a in args),
            jnp.asarray(cap_h), jnp.asarray(lat_h), jnp.asarray(slo_h), t=t,
            constrained=cap is not None,
            capfin=tuple(bool(np.isfinite(cap_h[:, j]).any())
                         for j in range(t)),
            slo_any=bool(np.isfinite(slo_h).any()), use_pallas=use_pallas)
        total, bounds, mig = (np.asarray(o) for o in out)
    feas = np.isfinite(total)
    return {"total": total, "bounds": np.where(feas[:, None], bounds, 0.0),
            "migrate": mig & feas}


# each T unconstrained and constrained once, each reduction three times
@pytest.mark.parametrize("t,constrained,use_pallas",
                         [(2, False, True), (3, False, False),
                          (4, False, True), (2, True, False),
                          (3, True, True), (4, True, False)])
def test_device_planner_matches_shp_jax(t, constrained, use_pallas):
    rng = np.random.default_rng(100 + 10 * t + constrained)
    m = 48
    args = _rand_batch(rng, m, t)
    cap = lat = slo = None
    if constrained:
        cap, lat, slo = _rand_constraints(rng, m, t, args[4])
    ref = _plan_impl(args, cap, lat, slo, use_pallas)
    got = t_dev.plan_ntier_arrays_device(*args, cap=cap, lat=lat, slo=slo,
                                         precision="float64", device="cpu")
    assert_f64_plan(args, ref, got)
    if constrained:  # both regimes exercised
        assert 0 < np.isfinite(ref["total"]).sum() < m


# ---------------------------------------------------------------------------
# against the NumPy oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,seed", [(2, 0), (3, 1), (4, 2)])
def test_device_planner_matches_oracle_unconstrained(t, seed):
    rng = np.random.default_rng(seed)
    args = _rand_batch(rng, 400, t)
    ref = j_shp.plan_ntier_arrays(*args, backend="numpy")
    got = t_dev.plan_ntier_arrays_device(*args, precision="float64",
                                         device="cpu")
    assert_f64_plan(args, ref, got)
    # the unconstrained default is float32
    f32 = t_shp.plan_ntier_arrays(*args, backend="device", device="cpu")
    assert f32["total"].dtype == np.float64
    assert_f32_plan(args, ref, f32)


@pytest.mark.parametrize("t,seed", [(2, 10), (3, 11), (4, 12)])
def test_device_planner_matches_oracle_constrained(t, seed):
    rng = np.random.default_rng(seed)
    args = _rand_batch(rng, 400, t)
    cap, lat, slo = _rand_constraints(rng, 400, t, args[4])
    ref = j_shp.plan_ntier_arrays(*args, cap=cap, lat=lat, slo=slo,
                                  backend="numpy")
    got = t_shp.plan_ntier_arrays(*args, cap=cap, lat=lat, slo=slo,
                                  backend="device", device="cpu")
    feas = np.isfinite(ref["total"])
    assert feas.sum() > 50 and (~feas).sum() > 5  # both regimes exercised
    assert_f64_plan(args, ref, got)


def test_chunked_solve_equals_one_chunk(monkeypatch):
    """Fleets larger than one chunk of device memory are solved chunk by
    chunk, with the fleet-wide gates fixed once: the same plans."""
    rng = np.random.default_rng(13)
    args = _rand_batch(rng, 300, 3)
    cap, lat, slo = _rand_constraints(rng, 300, 3, args[4])
    whole = t_dev.plan_ntier_arrays_device(*args, cap=cap, lat=lat, slo=slo,
                                           device="cpu")
    rows = t_dev._chunk_rows(3, True, (True, True, True), True, 8)
    monkeypatch.setattr(t_dev, "_CHUNK_BYTES", t_dev._CHUNK_BYTES // rows * 64)
    # several chunks of the 300 streams
    assert t_dev._chunk_rows(3, True, (True, True, True), True, 8) < 100
    chunked = t_dev.plan_ntier_arrays_device(*args, cap=cap, lat=lat,
                                             slo=slo, device="cpu")
    for key in ("total", "bounds", "migrate"):
        np.testing.assert_array_equal(chunked[key], whole[key])


def test_forced_constrained_trivial_matches_unconstrained():
    rng = np.random.default_rng(5)
    args = _rand_batch(rng, 200, 3)
    ref = j_shp.plan_ntier_arrays(*args, backend="numpy")
    got = t_shp.plan_ntier_arrays(*args, force_constrained=True,
                                  backend="device", device="cpu")
    assert_f64_plan(args, ref, got)


def test_waterfilled_fleet_plan_matches_reference():
    """The documented deployment's plan at a small size: the 3-tier fleet
    planned unconstrained (float32 rule), its shared hot-tier budget
    water-filled, and the binding streams re-solved under their grants
    (float64 rule), all against the JAX package's oracle."""
    rng = np.random.default_rng(0)
    m = 256
    jit = lambda lo, hi: rng.uniform(lo, hi, m)  # noqa: E731
    cw = np.stack([jit(0.8, 1.2) * 1e-6, jit(0.8, 1.2) * 2e-5,
                   jit(0.8, 1.2) * 8e-5], axis=1)
    cr = np.stack([jit(0.8, 1.2) * 2.7e-4, jit(0.8, 1.2) * 4e-5,
                   jit(0.8, 1.2) * 1e-6], axis=1)
    cs = np.stack([jit(0.8, 1.2) * 2.5e-6, jit(0.8, 1.2) * 1e-6,
                   jit(0.8, 1.2) * 2.5e-7], axis=1)
    args = (cw, cr, cs, np.full(m, 256.0), np.full(m, 8.0),
            rng.uniform(0.5, 4.0, m))
    ref = j_shp.plan_ntier_arrays(*args, backend="numpy")
    got = t_shp.plan_ntier_arrays(*args, backend="device", device="cpu")
    assert_f32_plan(args, ref, got)
    n, kv = args[3], args[4]
    desired = t_cons.peak_occupancy_arrays(got["bounds"], n, kv,
                                           got["migrate"])[:, 0]
    budget = float(desired.sum()) * 0.6
    grants = t_planner.waterfill(desired, budget)
    np.testing.assert_array_equal(
        grants, j_cons.waterfill_grants(desired, budget))
    idx = np.flatnonzero(grants < desired - 1e-9)
    assert idx.size > 10
    cap = np.full((idx.size, 3), np.inf)
    cap[:, 0] = grants[idx]
    sub = tuple(a[idx] for a in args)
    ref_c = j_shp.plan_ntier_arrays(*sub, cap=cap, backend="numpy")
    got_c = t_shp.plan_ntier_arrays(*sub, cap=cap, backend="device",
                                    device="cpu")
    assert_f64_plan(sub, ref_c, got_c)
    bounds, mig = got["bounds"].copy(), got["migrate"].copy()
    bounds[idx], mig[idx] = got_c["bounds"], got_c["migrate"]
    hot = t_cons.peak_occupancy_arrays(bounds, n, kv, mig)[:, 0].sum()
    assert hot <= budget * (1 + 1e-9) + 1e-6


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@pytest.fixture
def device_calls(monkeypatch):
    """Pretend a CUDA card is present and record the device solver's
    calls, which run on the CPU."""
    calls = []
    real = t_dev.plan_ntier_arrays_device

    def spy(*args, **kw):
        calls.append(kw.pop("device"))
        return real(*args, device="cpu", **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(t_dev, "plan_ntier_arrays_device", spy)
    return calls


def test_auto_rule(device_calls):
    rng = np.random.default_rng(3)
    for m, t, con, want in ((63, 3, False, 0), (64, 3, False, 1),
                            (64, 4, False, 1), (64, 3, True, 1),
                            (64, 4, True, 0), (64, 5, False, 0),
                            (64, 2, True, 1)):
        args = _rand_batch(rng, m, t)
        cap = None
        if con:
            cap = np.full((m, t), np.inf)
            cap[:, 0] = args[4]
        n0 = len(device_calls)
        out = t_shp.plan_ntier_arrays(*args, cap=cap)
        assert len(device_calls) - n0 == want, (m, t, con)
        ref = j_shp.plan_ntier_arrays(*args, cap=cap, backend="numpy")
        if not want:  # the host solver: bit-equal to the reference's
            np.testing.assert_array_equal(out["total"], ref["total"])
    # a CPU device keeps the host solver under "auto"
    args = _rand_batch(rng, 128, 3)
    out = t_shp.plan_ntier_arrays(*args, device="cpu")
    assert len(device_calls) == 4
    np.testing.assert_array_equal(
        out["total"], j_shp.plan_ntier_arrays(*args, backend="numpy")["total"])


def test_engine_plans_on_its_device(device_calls):
    """The engine hands its own device to the planner: a CPU engine keeps
    the host solver, while the planner's default picks the (here
    pretended) card."""
    rng = np.random.default_rng(6)
    models = [build_model(T_PKG, draw_model(rng, 3)) for _ in range(64)]
    eng = t_eng.StreamEngine([t_eng.StreamSpec(stream_id=i, k=cm.workload.k,
                                               cost_model=cm)
                              for i, cm in enumerate(models)], device="cpu")
    assert device_calls == [] and eng.plan.m == 64
    plan = t_planner.plan_fleet_mixed(models)
    assert device_calls == [None]
    assert np.isfinite(plan.totals).all()


def test_backend_names_and_missing_card(monkeypatch):
    args = _rand_batch(np.random.default_rng(4), 8, 3)
    with pytest.raises(ValueError, match="'device'"):
        t_shp.plan_ntier_arrays(*args, backend="jax")
    with pytest.raises(ValueError, match="unknown planner backend"):
        t_shp.plan_ntier_arrays(*args, backend="tpu")
    with pytest.raises(t_dev.DeviceSolverUnavailable):
        t_shp.plan_ntier_arrays(*_rand_batch(np.random.default_rng(4), 8, 5),
                                backend="device", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_shp.plan_ntier_arrays(*args, backend="device")
    # "auto" without a card plans on the host
    out = t_shp.plan_ntier_arrays(*_rand_batch(np.random.default_rng(4),
                                               64, 3))
    assert np.isfinite(out["total"]).all()
