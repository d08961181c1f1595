"""repro_torch.kernels.plan_solve: the plain PyTorch version of the fused
plan-solve reduction against the JAX package's Pallas kernel (interpret
mode on the CPU, inside ``jax.enable_x64``) and against the reference's
jnp enumeration ``ref.enum_solve`` fed the same terms with the masks
folded in as +inf. The CUDA kernel is held against this plain version on
the card by tests/test_torch_cuda.py.

Tolerance: exact. Both sides add the same terms in the same order, so
``val`` is compared bit for bit, ``s_idx`` and ``sel`` with equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.plan_solve import ops as j_ops
from repro.kernels.plan_solve import ref as j_ref
from repro_torch.kernels.plan_solve import ops as t_ops
from test_torch_cuda import ps_case, ps_tensors

# J in {1, 2, 3}; unmasked, masked, lower bounds, latency budget, all
# three with an all-infeasible stream, exact ties (J = 3 at C = 12: 364
# tuples a subset); a NaN-skipped first subset before infeasible ones,
# and a NaN in the last tuple of the last subset alone; float64 and
# float32
CASES = [(16, 3, 1, 4, "plain", np.float64), (16, 2, 1, 6, "masked",
                                                np.float64),
         (16, 1, 2, 6, "plain", np.float64), (16, 3, 2, 8, "lb", np.float64),
         (16, 2, 2, 6, "budget", np.float64), (16, 3, 2, 8, "all",
                                               np.float64),
         (16, 3, 2, 5, "ties", np.float64), (8, 2, 3, 7, "all", np.float64),
         (8, 2, 3, 5, "ties", np.float64), (16, 3, 2, 6, "all", np.float32),
         (8, 2, 3, 12, "ties", np.float64),
         (16, 3, 2, 6, "nan_then_inf", np.float64),
         (16, 3, 2, 6, "nan_then_inf", np.float32),
         (16, 3, 2, 6, "late_nan", np.float64)]


def _jax_kwargs(case):
    out = {}
    for key, v in case.items():
        if key in ("fs", "consts"):
            continue
        out[key] = ([jnp.asarray(a) for a in v] if isinstance(v, list)
                    else jnp.asarray(v))
    return out


@pytest.mark.parametrize("m,s,j,c,kind,dtype", CASES)
def test_enum_solve_plain_equals_pallas(m, s, j, c, kind, dtype):
    case = ps_case(m, s, j, c, kind, m * 7 + c, dtype)
    with jax.enable_x64(True):
        jv, js, jsel = j_ops.enum_solve(
            jnp.asarray(case["fs"]),
            tuple(jnp.asarray(cc) for cc in case["consts"]),
            use_pallas=True, **_jax_kwargs(case))
        jv, js, jsel = np.asarray(jv), np.asarray(js), np.asarray(jsel)
    fs, consts, kw = ps_tensors(case, "cpu")
    tv, ts, tsel = t_ops.enum_solve(fs, consts, **kw)
    assert tv.dtype == torch.from_numpy(case["fs"]).dtype
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tsel.numpy(), jsel)
    if kind == "all":
        assert tv[0] == np.inf and ts[0] == 0 and (tsel[0] == 0).all()
    if kind == "ties":  # ties were there to break
        assert len(np.unique(jv)) < m
    if kind == "nan_then_inf":  # not s = 1's winner: the index stays 0
        cut = np.isnan(case["fs"][:, 0, 0, 0])
        assert cut.any() and (jv[cut] == np.inf).all()
        assert (js[cut] == 0).all() and (jsel[cut] == 0).all()


@pytest.mark.parametrize("m,s,j,c,kind,dtype",
                         [cs for cs in CASES if cs[-1] == np.float64
                          and cs[4] in ("masked", "lb", "budget", "all")])
def test_enum_solve_plain_equals_jnp_enumeration(m, s, j, c, kind, dtype):
    """The gathered jnp enumeration, masks folded into the terms as +inf
    (the host solver's convention), reaches the same winner."""
    case = ps_case(m, s, j, c, kind, m * 7 + c, dtype)
    fs = case["fs"].copy()
    for jj, mk in enumerate(case.get("masks") or []):
        fs[:, :, jj, :] = np.where(mk, fs[:, :, jj, :], np.inf)
    kw = _jax_kwargs({key: v for key, v in case.items() if key != "masks"})
    with jax.enable_x64(True):
        out = j_ref.enum_solve(
            jnp.asarray(fs), tuple(jnp.asarray(cc) for cc in case["consts"]),
            j_ops.monotone_combos(c, j), **kw)
        jv, js, jsel = (np.asarray(o) for o in out)
    tfs, consts, tkw = ps_tensors(case, "cpu")
    tv, ts, tsel = t_ops.enum_solve(tfs, consts, **tkw)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tsel.numpy(), jsel)


@pytest.mark.parametrize("c,j", [(1, 1), (4, 1), (6, 2), (8, 2), (5, 3),
                                 (21, 3)])
def test_monotone_combos_equal_reference(c, j):
    np.testing.assert_array_equal(t_ops.monotone_combos(c, j),
                                  j_ops.monotone_combos(c, j))


def test_nan_subset_is_skipped_whole():
    """A subset holding a NaN tuple never wins (the reference's
    NaN-propagating min), though its other tuples are cheaper; a stream
    whose every subset holds one returns (+inf, 0)."""
    fs = torch.tensor([[[[0.0, -5.0, np.nan]], [[1.0, 2.0, 3.0]]],
                       [[[np.nan, 0.0, 0.0]], [[0.0, np.nan, 0.0]]]])
    consts = [torch.zeros(2, 2)] * 3
    val, s_idx, sel = t_ops.enum_solve(fs, consts, cand=torch.zeros(2, 2, 3))
    assert val.tolist() == [1.0, np.inf]
    assert s_idx.tolist() == [1, 0] and sel[:, 0].tolist() == [0, 0]


def test_wrapper_dispatch_and_checks():
    fs, consts, kw = ps_tensors(ps_case(4, 2, 2, 5, "all", 0), "cpu")
    args = t_ops.solve_inputs(fs, consts, **kw)
    n0 = t_ops.launches
    for a, r in zip(t_ops.plan_solve(*args), t_ops.reference(*args)):
        assert torch.equal(a, r)
    assert t_ops.launches == n0  # the CPU runs the plain version
    with pytest.raises(ValueError, match="no kernel"):
        t_ops.plan_solve(fs.to("meta"), *args[1:])
    with pytest.raises(ValueError, match="grid must be"):
        t_ops.reference(args[0], args[1], args[2],
                        (args[3][0].float(),) + args[3][1:])


def test_nan_term_in_masked_column_follows_the_jnp_route():
    """The recorded divergence (ROADMAP queue 3): a NaN term in a masked
    column. The Pallas route's one-hot matmul spreads it to every tuple
    (NaN · 0), so the subset is skipped; the gather leaves it in the
    masked tuple, which is +inf, and keeps the feasible one — as the jnp
    route (and the host solver) with the mask folded in as +inf do."""
    fs = np.array([[[[np.nan, 0.0]]]])
    consts = [np.zeros((1, 1))] * 3
    cand = np.array([[[1.0, 2.0]]])
    mask = np.array([[[False, True]]])
    with jax.enable_x64(True):
        pallas = j_ops.enum_solve(
            jnp.asarray(fs), tuple(jnp.asarray(c) for c in consts),
            cand=jnp.asarray(cand), masks=[jnp.asarray(mask)],
            use_pallas=True)
        folded = j_ref.enum_solve(
            jnp.asarray(np.where(mask[:, :, None], fs, np.inf)),
            tuple(jnp.asarray(c) for c in consts),
            j_ops.monotone_combos(2, 1), cand=jnp.asarray(cand))
        pallas, folded = ([np.asarray(o) for o in out]
                          for out in (pallas, folded))
    port = t_ops.enum_solve(torch.tensor(fs),
                            [torch.tensor(c) for c in consts],
                            cand=torch.tensor(cand),
                            masks=[torch.tensor(mask)])
    assert [o.tolist() for o in pallas] == [[np.inf], [0], [[0]]]
    assert [o.tolist() for o in folded] == [[0.0], [0], [[1]]]
    assert [o.tolist() for o in port] == [[0.0], [0], [[1]]]


def _shapes(m, s, j, c, masked, dtype, g=None):
    """Meta tensors of plan_solve's inputs: shapes and types alone."""
    meta = dict(device="meta", dtype=dtype)
    g = len(t_ops.monotone_combos(c, j)) if g is None else g
    grids = None
    if masked:
        grids = (torch.empty((m, s, c), **meta),
                 torch.empty((m, s, j, c), device="meta", dtype=torch.bool),
                 torch.empty((m, s, max(j - 1, 1), c), **meta),
                 torch.empty((m, s, j, c), **meta),
                 torch.empty((m, s, 2), **meta))
    return (torch.empty((m, s, j, c), **meta), torch.empty((m, s, 3), **meta),
            torch.empty((g, j), device="meta", dtype=torch.uint8), grids)


# the launches of phase 4 of chip_smoke.py: the 1,000,000-stream plan,
# the 400,000-stream re-solve and the 4-tier constrained fleet
@pytest.mark.parametrize("m,s,j,c,masked,dtype,mapping,threads", [
    (1_000_000, 3, 1, 4, False, torch.float32, "rows", 128),
    (1_000_000, 1, 2, 6, False, torch.float32, "rows", 128),
    (400_000, 3, 1, 6, True, torch.float64, "rows", 32),
    (400_000, 1, 2, 8, True, torch.float64, "rows", 32),
    (4096, 6, 1, 9, True, torch.float64, "rows", 32),
    (4096, 4, 2, 19, True, torch.float64, "streams", 192),
    (4096, 1, 3, 31, True, torch.float64, "streams", 256),
    (4096, 3, 2, 12, False, torch.float64, "streams", 96),
    (4096, 1, 3, 17, False, torch.float64, "streams", 256)])
def test_launch_plan_picks_the_mapping_from_g(m, s, j, c, masked, dtype,
                                              mapping, threads):
    args = _shapes(m, s, j, c, masked, dtype)
    g = args[2].shape[0]
    got, tile, nthreads, smem = t_ops.launch_plan(*args)
    assert (got, nthreads) == (mapping, threads)
    assert (got == "streams") == (g >= t_ops.STREAMS_MIN_G or j > 3)
    size = args[0].element_size()
    if got == "rows":  # a thread a stream; the tile near its target
        assert 1 < tile <= nthreads < tile + 32
        assert smem == t_ops._smem_bytes(tile, s, j, c, g, 3, masked, size,
                                         "rows")
        assert t_ops._smem_bytes(tile, s, j, c, 10 * g, 3, masked, size,
                                 "rows") == smem  # no combo table
        assert smem <= 2 * t_ops.TILE_BYTES + 1024  # two buffers
    else:
        assert tile == 1
        assert smem == t_ops._smem_bytes(1, s, j, c, g, 3, masked, size,
                                         "streams", s * threads // 32)
    assert smem <= t_ops.SMEM_LIMIT


@pytest.mark.parametrize("n,stride", [(4, 5), (12, 13), (9, 9), (16, 17),
                                      (3, 3), (1, 1)])
def test_staged_rows_lie_at_odd_strides(n, stride):
    """A warp's threads, one stream each, read distinct banks: an odd
    number of 4-byte (float32) or 8-byte (float64) words between two
    streams' staged rows."""
    assert t_ops._pad(n) == stride >= n and stride % 2 == 1


def test_cuda_cases_cross_both_mappings():
    """tests/test_torch_cuda.py's plan_solve cases reach both kernels,
    each with ties, late NaNs, a NaN-skipped first subset and a lone
    stream; the tiles of streams with a partial last tile and every J
    and masking they are built for."""
    from test_torch_cuda import PS_CASES
    seen = set()
    for m, s, j, c, kind in PS_CASES:
        for dtype in (torch.float32, torch.float64):
            masked = kind in ("masked", "lb", "budget", "all")
            mapping, tile, *_ = t_ops.launch_plan(
                *_shapes(m, s, j, c, masked, dtype))
            seen.add((mapping, kind))
            seen.add((mapping, "partial tile" if m % tile else "whole"))
            seen.add((mapping, f"M={m}"))
            seen.add((mapping, f"J={j}", masked))
    for mapping in ("rows", "streams"):
        for kind in ("all", "ties", "late_nan", "nan_then_inf", "M=1"):
            assert (mapping, kind) in seen, (mapping, kind)
    assert ("rows", "partial tile") in seen
    for j in (1, 2, 3):  # every instantiation of the tiles' kernel
        for masked in (False, True):
            assert ("rows", f"J={j}", masked) in seen, (j, masked)
    assert ("streams", "J=4", True) in seen


def test_launch_plan_raises_beyond_shared_memory():
    with pytest.raises(ValueError, match="streams.*shared memory"):
        t_ops.launch_plan(*_shapes(64, 1, 3, 70, True, torch.float64,
                                   g=80_000))
    with pytest.raises(ValueError, match="rows.*shared memory"):
        t_ops.launch_plan(*_shapes(64, 200, 1, 63, True, torch.float64))
