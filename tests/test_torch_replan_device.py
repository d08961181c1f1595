"""repro_torch's device suffix re-solve (``online.replan_device``) and the
plain-torch reductions it runs (``kernels.plan_solve.ref``), on the CPU:

* ``ref.single_arr``, ``tri_arr``, ``dp_arr``, ``value_argmin``,
  ``first_argmin`` and ``pick_col`` against the reference's jnp versions
  (``repro.kernels.plan_solve.ref``) under ``jax.enable_x64``, bit for
  bit, with ties, +inf rows and all-inf rows;
* ``replan_device.solve_group(..., device="cpu")`` (the four-tier
  subsets through ``plan_solve``'s plain version) against the reference's
  ``replan_device._solve_impl`` run eagerly under ``jax.enable_x64`` —
  its public entry needs the import that fails on this jax, the function
  itself runs — for T = 2, 3 and 4, constrained (first/last-tier caps
  folded as +inf, middle-tier pair caps, a latency budget) or not, with
  relocation allowed or blocked: bounds equal, totals and old-plan costs
  within 1e-11 relative (eager XLA and torch may round a log differently
  in the last bit);
* the port's ``Replanner(backend="device", device="cpu")`` against the
  reference ``Replanner``'s NumPy loop, with the reference's own
  tolerances for that comparison (tests/test_plan_device.py:
  decisions equal, suffix costs 1e-10 relative, bounds rtol 1e-6 / atol
  1e-3, since the NumPy loop may break ties between equal-cost tuples
  differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constraints as j_cons
from repro.core import costs as j_costs
from repro.core import topology as j_topo
from repro.kernels.plan_solve import ref as j_ref
from repro.online import replan as j_replan
from repro.online import replan_device as j_rd
from repro_torch.core import constraints as t_cons
from repro_torch.core import costs as t_costs
from repro_torch.core import topology as t_topo
from repro_torch.kernels.plan_solve import ref as t_ref
from repro_torch.online import replan as t_replan
from repro_torch.online import replan_device as t_rd

REL = 1e-11


def same_bits(a, b):
    """Floats equal bit for bit in one dtype; integer indices equal in
    value (under x64 the reference sums int32 picks into int64)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (a, b)
    if a.dtype.kind == "f":
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        assert np.array_equal(a.view(np.int64 if a.itemsize == 8 else
                                     np.int32),
                              b.view(np.int64 if b.itemsize == 8 else
                                     np.int32)), (a, b)
    else:
        assert np.array_equal(a, b), (a, b)


def grid_case(seed, m=24, c=11):
    """Unsorted candidate grids with duplicated values, tied terms, +inf
    terms, one all-+inf row and one row whose minimum is tied at two
    candidate values."""
    rng = np.random.default_rng(seed)
    cand = rng.choice(np.linspace(0.0, 5000.0, 7), (m, c))
    f0 = np.round(rng.uniform(-1, 1, (m, c)), 2)
    f1 = np.round(rng.uniform(-1, 1, (m, c)), 2)
    f0[rng.random((m, c)) < 0.2] = np.inf
    f1[rng.random((m, c)) < 0.2] = np.inf
    f0[0] = np.inf
    f0[1] = 0.5
    f0[1, [3, 7]] = -1.0
    return cand, f0, f1


def test_first_argmin_pick_col_value_argmin_bit_equal():
    for seed in range(3):
        cand, f0, _ = grid_case(seed)
        with jax.enable_x64(True):
            jv, ji = j_ref.first_argmin(jnp.asarray(f0))
            jbv = j_ref.value_argmin(jnp.asarray(f0), jnp.asarray(cand))
            jp = j_ref.pick_col(jnp.asarray(cand), jnp.asarray(
                np.arange(24) % 11, jnp.int32))
            jv, ji, jbv, jp = (np.asarray(x) for x in (jv, ji, jbv, jp))
        tv, ti = t_ref.first_argmin(torch.tensor(f0))
        tbv = t_ref.value_argmin(torch.tensor(f0), torch.tensor(cand))
        tp = t_ref.pick_col(torch.tensor(cand), torch.tensor(
            np.arange(24) % 11, dtype=torch.int32))
        same_bits(jv, tv.numpy())
        same_bits(ji, ti.numpy())
        for a, b in zip(jbv, tbv):
            same_bits(a, b.numpy())
        same_bits(jp, tp.numpy())


@pytest.mark.parametrize("budget", [False, True])
def test_single_arr_bit_equal(budget):
    cand, f0, _ = grid_case(7)
    m = cand.shape[0]
    rng = np.random.default_rng(1)
    alpha = [rng.uniform(-1e-3, 1e-3, m)]
    rhs, atol = rng.uniform(-1, 2, m), np.full(m, 1e-12)
    kw_np = dict(alpha=alpha, rhs=rhs, atol=atol) if budget else {}
    with jax.enable_x64(True):
        kw = {k: ([jnp.asarray(a) for a in v] if isinstance(v, list)
                  else jnp.asarray(v)) for k, v in kw_np.items()}
        jv, (jb,) = j_ref.single_arr(jnp.asarray(f0), jnp.asarray(cand),
                                     **kw)
        jv, jb = np.asarray(jv), np.asarray(jb)
    kw = {k: ([torch.tensor(a) for a in v] if isinstance(v, list)
              else torch.tensor(v)) for k, v in kw_np.items()}
    tv, (tb,) = t_ref.single_arr(torch.tensor(f0), torch.tensor(cand), **kw)
    same_bits(jv, tv.numpy())
    same_bits(jb, tb.numpy())


@pytest.mark.parametrize("caps,budget", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_tri_arr_bit_equal(caps, budget):
    cand, f0, f1 = grid_case(11 + 2 * caps + budget)
    m = cand.shape[0]
    rng = np.random.default_rng(2)
    kw_np = {}
    if caps:
        kf = rng.uniform(50, 200, m)
        cap_m = np.where(rng.random(m) < 0.7, kf * rng.uniform(0.2, 1.2, m),
                         np.inf)
        kw_np.update(kf=kf, cap_m=cap_m)
    if budget:
        kw_np.update(alpha=[rng.uniform(-1e-3, 1e-3, m),
                            rng.uniform(-1e-3, 1e-3, m)],
                     rhs=rng.uniform(-1, 2, m), atol=np.full(m, 1e-12))
    with jax.enable_x64(True):
        kw = {k: ([jnp.asarray(a) for a in v] if isinstance(v, list)
                  else jnp.asarray(v)) for k, v in kw_np.items()}
        jv, jb = j_ref.tri_arr(jnp.asarray(f0), jnp.asarray(f1),
                               jnp.asarray(cand), **kw)
        jv, jb = np.asarray(jv), [np.asarray(b) for b in jb]
    kw = {k: ([torch.tensor(a) for a in v] if isinstance(v, list)
              else torch.tensor(v)) for k, v in kw_np.items()}
    tv, tb = t_ref.tri_arr(torch.tensor(f0), torch.tensor(f1),
                           torch.tensor(cand), **kw)
    same_bits(jv, tv.numpy())
    for a, b in zip(jb, tb):
        same_bits(a, b.numpy())
    assert np.isinf(jv[0])  # the all-+inf row


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_dp_arr_bit_equal(steps):
    rng = np.random.default_rng(steps)
    fs = [np.round(rng.uniform(-1, 1, (20, 9)), 1) for _ in range(steps)]
    for f in fs:
        f[rng.random(f.shape) < 0.15] = np.inf
    fs[0][0] = np.inf
    with jax.enable_x64(True):
        jv, js = j_ref.dp_arr([jnp.asarray(f) for f in fs])
        jv, js = np.asarray(jv), [np.asarray(s) for s in js]
    tv, ts = t_ref.dp_arr([torch.tensor(f) for f in fs])
    same_bits(jv, tv.numpy())
    for a, b in zip(js, ts):
        same_bits(a, b.numpy())


# ---------------------------------------------------------------------------
# the suffix re-solve
# ---------------------------------------------------------------------------

def draw_online(rng, r, t):
    """Numbers of r random t-tier re-plan models (the reference test's
    ``_online_models`` shape: write-cheap/read-expensive hot tiers, costs
    jittered) and their constraint draws."""
    out = []
    for _ in range(r):
        tiers = []
        put, get, rent = 1e-6, 3e-4, 0.05
        for _ in range(t):
            tiers.append((put * rng.uniform(0.8, 1.2),
                          get * rng.uniform(0.8, 1.2), rent,
                          float(10.0 ** rng.uniform(-3, 1))))
            put *= 40.0
            get /= 40.0
            rent /= 3.0
        n = int(rng.integers(5_000, 50_000))
        k = int(rng.integers(8, 128))
        out.append(dict(tiers=tiers, n=n, k=k,
                        caps=[float(k * rng.uniform(0.3, 2.0))
                              if rng.uniform() < 0.8 else None
                              for _ in range(t)],
                        slo=(float(10.0 ** rng.uniform(-2, 0.5))
                             if rng.uniform() < 0.5 else None)))
    return out


def build_online(pkg, d, constrained):
    costs, topology, cons = pkg
    specs = tuple(topology.TierSpec(
        costs.TierCosts("t", put_per_doc=p, get_per_doc=g,
                        storage_per_gb_month=s), read_latency_s=lat)
        for p, g, s, lat in d["tiers"])
    wl = costs.WorkloadSpec(n_docs=d["n"], k=d["k"], doc_gb=1e-4,
                            window_months=0.5)
    cm = topology.TierTopology(tiers=specs).cost_model(wl)
    cs = []
    if constrained:
        cs = [cons.TierCapacity(j, c) for j, c in enumerate(d["caps"])
              if c is not None]
        if d["slo"] is not None:
            cs.append(cons.ReadLatencySLO(d["slo"]))
    return cm, cons.ConstraintSet(*cs)


J = (j_costs, j_topo, j_cons)
T = (t_costs, t_topo, t_cons)


def group_inputs(t, constrained, seed, r=24):
    """The stacked arrays ``Replanner._solve_group`` hands the device
    path, built by the reference's own Replanner."""
    rng = np.random.default_rng(seed)
    draws = draw_online(rng, r, t)
    built = [build_online(J, d, constrained) for d in draws]
    rp = j_replan.Replanner([b[0] for b in built],
                            constraints=[b[1] for b in built])
    st = rp._stacks[t]
    n = st["n"]
    n0 = np.floor(rng.uniform(0.1, 0.9, r) * n)
    rho = rng.uniform(0.3, 8.0, r)
    b0 = np.sort(rng.uniform(0, 1, (r, t - 1)) * n[:, None], axis=1)
    b0[0] = 0.0  # a single-tier (last tier) plan
    b0[1, : t - 1] = n[1]  # a first-tier plan
    return ([st[key] for key in ("cw", "cr", "cs", "n", "k", "rpw", "cap",
                                 "lat", "slo")] + [n0, rho, b0])


def reference_solve(args, allow_moves):
    cap, slo = args[6], args[8]
    t = args[0].shape[1]
    with jax.enable_x64(True):
        out = j_rd._solve_impl(
            *(jnp.asarray(a, jnp.float64) for a in args), t=t,
            constrained=not j_cons.trivial(cap, slo),
            capfin=tuple(bool(np.isfinite(cap[:, j]).any())
                         for j in range(t)),
            slo_any=bool(np.isfinite(slo).any()), allow_moves=allow_moves)
        return [np.asarray(o) for o in out]


@pytest.mark.parametrize("allow_moves", [True, False])
@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("t", [2, 3, 4])
def test_solve_group_matches_reference_solve_impl(t, constrained,
                                                  allow_moves):
    args = group_inputs(t, constrained, seed=40 + 4 * t + 2 * constrained
                        + allow_moves)
    ref_total, ref_bounds, ref_old = reference_solve(args, allow_moves)
    total, bounds, old = t_rd.solve_group(*args, allow_moves=allow_moves,
                                          device="cpu")
    np.testing.assert_array_equal(np.isfinite(total), np.isfinite(ref_total))
    fin = np.isfinite(ref_total)
    np.testing.assert_allclose(total[fin], ref_total[fin], rtol=REL, atol=0)
    np.testing.assert_array_equal(bounds[fin], ref_bounds[fin])
    np.testing.assert_allclose(old, ref_old, rtol=REL, atol=0)
    if constrained:
        assert fin.any()


def test_solve_group_four_tier_reaches_plan_solve_with_inf_terms(
        monkeypatch):
    """The four-tier subset goes through ``ops.enum_solve`` (the kernel's
    entry) with pair caps and +inf terms from the folded capacity
    masks."""
    from repro_torch.kernels.plan_solve import ops as t_ops
    seen = []
    real = t_ops.enum_solve

    def spy(fs, consts, **kw):
        seen.append((tuple(fs.shape), bool(torch.isinf(fs).any()),
                     kw.get("pair_caps") is not None))
        return real(fs, consts, **kw)

    monkeypatch.setattr(t_ops, "enum_solve", spy)
    args = group_inputs(4, True, seed=3)
    t_rd.solve_group(*args, device="cpu")
    assert len(seen) == 1
    shape, has_inf, masked = seen[0]
    assert shape[:3] == (24, 1, 3) and has_inf and masked


@pytest.mark.parametrize("t,constrained", [(2, False), (3, True),
                                           (4, False), (4, True)])
def test_port_device_route_matches_reference_numpy_loop(t, constrained):
    rng = np.random.default_rng(31 + t + 10 * constrained)
    r = 24
    draws = draw_online(rng, r, t)
    n = np.array([d["n"] for d in draws], np.float64)
    n0 = rng.uniform(0.1, 0.9, r) * n
    rho = rng.uniform(0.3, 8.0, r)
    bounds = [tuple(sorted(rng.uniform(0, n[i], t - 1))) for i in range(r)]
    mig = rng.random(r) < 0.15
    decs = []
    for pkg, mod, kw in ((J, j_replan, dict(backend="numpy")),
                         (T, t_replan, dict(backend="device",
                                            device="cpu"))):
        built = [build_online(pkg, d, constrained) for d in draws]
        rp = mod.Replanner([b[0] for b in built],
                           constraints=[b[1] for b in built], **kw)
        decs.append(rp.replan(np.arange(r), n0, rho, bounds, mig))
    d_np, d_dev = decs
    for f in ("considered", "applied", "feasible"):
        np.testing.assert_array_equal(getattr(d_np, f), getattr(d_dev, f))
    cn, cd = d_np.suffix_cost_new, d_dev.suffix_cost_new
    np.testing.assert_array_equal(np.isfinite(cn), np.isfinite(cd))
    both = np.isfinite(cn)
    np.testing.assert_allclose(cd[both], cn[both], rtol=1e-10)
    np.testing.assert_allclose(d_dev.suffix_cost_old, d_np.suffix_cost_old,
                               rtol=1e-10, equal_nan=True)
    for a, b in zip(d_np.new_bounds, d_dev.new_bounds):
        np.testing.assert_allclose(np.asarray(b, float),
                                   np.asarray(a, float), rtol=1e-6,
                                   atol=1e-3)


def test_backends_dispatch():
    d = draw_online(np.random.default_rng(0), 1, 2)[0]
    cm, _ = build_online(T, d, False)
    with pytest.raises(ValueError, match="'device'"):
        t_replan.Replanner([cm], backend="jax")
    with pytest.raises(ValueError, match="unknown"):
        t_replan.Replanner([cm], backend="tpu")
    # "auto" on the CPU keeps the NumPy loop; "device" runs replan_device
    calls = []
    real = t_rd.solve_group

    def spy(*a, **kw):
        calls.append(kw["device"])
        return real(*a, **kw)

    t_rd.solve_group = spy
    try:
        args = ([0], [0.3 * d["n"]], [4.0], [(0.5 * d["n"],)], [False])
        t_replan.Replanner([cm], device="cpu").replan(*args)
        assert calls == []
        t_replan.Replanner([cm], backend="device", device="cpu").replan(*args)
        assert calls == ["cpu"]
    finally:
        t_rd.solve_group = real
    with pytest.raises(ValueError, match="covers"):
        t_rd.solve_group(*([np.ones((1, 5))] * 3 + [np.ones(1)] * 3
                           + [np.full((1, 5), np.inf), np.zeros((1, 5)),
                              np.full(1, np.inf), np.ones(1), np.ones(1),
                              np.zeros((1, 4))]), device="cpu")
