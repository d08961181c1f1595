"""repro_torch kernels: each plain PyTorch version vs the JAX package's
Pallas kernel (interpret mode on the CPU, ``use_pallas=True``) and the
wrappers' device dispatch. The kernels themselves are held against their
plain versions on the card by tests/test_torch_cuda.py.

Tolerance: exact. Masks, counts, tiers and per-tier counts are integers;
tile maxima are elements of the input (or NEG_BIG, or NaN where a tile
holds one), so they are compared with array equality too (NaN equal to
NaN). The launch plans name the card's kernel for a width, an alignment
and a contiguity; they are pure functions of the tensor's shape and
address, so they run here on CPU tensors.
"""
import numpy as np
import pytest
import torch

from repro.kernels.batched_topk import ops as j_btk
from repro.kernels.tier_assign import ops as j_ta
from repro_torch.kernels.batched_topk import ops as t_btk
from repro_torch.kernels.tier_assign import ops as t_ta
from test_torch_cuda import (BTK_CASES, BTK_SEAM_CASES, TA_CASES,
                             TA_SEAM_CASES, btk_case, btk_seam_case,
                             offset_view, ta_case, ta_edge_case)


@pytest.mark.parametrize("m,n", BTK_CASES)
def test_batched_topk_plain_equals_pallas(m, n):
    scores, bars = btk_case(m, n, m * 1000 + n)
    jm, jc, jx = j_btk.batched_topk_filter(scores, bars, use_pallas=True)
    tm, tc, tx = t_btk.batched_topk_filter(torch.tensor(scores),
                                           torch.tensor(bars))
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())


@pytest.mark.parametrize("m,k,b", TA_CASES)
def test_tier_assign_plain_equals_pallas(m, k, b):
    ids, bounds, floor = ta_case(m, k, b, m * 100 + k)
    jt, jc = j_ta.tier_assign(ids, bounds, floor, use_pallas=True)
    tt, tc = t_ta.tier_assign(
        torch.tensor(ids), torch.tensor(t_ta.quantize_boundaries(bounds)),
        torch.tensor(floor))
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())


def test_quantize_boundaries_equals_reference():
    b = np.array([[5.3, 6.0, np.inf, -np.inf, 3e9, -2.5]])
    np.testing.assert_array_equal(t_ta.quantize_boundaries(b),
                                  j_ta.quantize_boundaries(b))


def test_wrappers_run_plain_on_cpu_and_refuse_other_devices():
    scores, bars = btk_case(3, 16, 0)
    before = (t_btk.launches, t_ta.launches)
    out = t_btk.batched_topk_filter(torch.tensor(scores), torch.tensor(bars))
    ref = t_btk.reference(torch.tensor(scores), torch.tensor(bars))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    ids, bounds, floor = ta_case(3, 8, 2, 0)
    args = (torch.tensor(ids), torch.tensor(t_ta.quantize_boundaries(bounds)),
            torch.tensor(floor))
    assert all(torch.equal(a, b) for a, b in
               zip(t_ta.tier_assign(*args), t_ta.reference(*args, 3)))
    assert (t_btk.launches, t_ta.launches) == before  # no kernel ran
    with pytest.raises(ValueError, match="no kernel"):
        t_btk.batched_topk_filter(torch.tensor(scores).to("meta"),
                                  torch.tensor(bars).to("meta"))
    with pytest.raises(ValueError, match="float32"):
        t_btk.batched_topk_filter(torch.tensor(scores).double(),
                                  torch.tensor(bars))
    with pytest.raises(ValueError, match="int32"):
        t_ta.tier_assign(args[0].long(), args[1], args[2])


def _pallas_and_plain_agree(jax_outs, torch_outs):
    for j, t in zip(jax_outs, torch_outs):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("m,n,kind", sorted(
    {(m, n, kind) for m, n, kind, _, _ in BTK_SEAM_CASES if m < 100}))
def test_batched_topk_edges_plain_equals_pallas(m, n, kind):
    """NaN scores and bars (NaN tile maxima), signed zeros at the bar, -inf
    bars counting the pad columns (112 at N = 16), at the widths the
    card's kernels split on."""
    scores, bars = btk_seam_case(m, n, kind, m + n)
    _pallas_and_plain_agree(
        j_btk.batched_topk_filter(scores, bars, use_pallas=True),
        t_btk.batched_topk_filter(torch.tensor(scores), torch.tensor(bars)))


def test_batched_topk_pad_columns_at_the_main_width():
    scores, bars = btk_seam_case(9, 16, "ninf", 0)
    _, counts, tmax = t_btk.batched_topk_filter(torch.tensor(scores),
                                                torch.tensor(bars))
    hits = (scores > -np.inf).sum(axis=1)
    np.testing.assert_array_equal(counts.numpy()[:, 0], hits + 112)
    assert (tmax.numpy() >= t_btk.NEG_BIG).all()


@pytest.mark.parametrize("m,k,b,t", sorted(
    {(m, k, b, t) for m, k, b, t, _, _ in TA_SEAM_CASES if m < 100}))
def test_tier_assign_edges_plain_equals_pallas(m, k, b, t):
    """Ids at the boundaries and at INT32_MAX - 1, negative pads, floors of
    T - 1, T from 1 to 8, at the widths the card's kernels split on."""
    ids, bounds, floor = ta_edge_case(m, k, b, t, m + k + b + t)
    _pallas_and_plain_agree(
        j_ta.tier_assign(ids, bounds, floor, n_tiers=t, use_pallas=True),
        t_ta.tier_assign(
            torch.tensor(ids), torch.tensor(t_ta.quantize_boundaries(bounds)),
            torch.tensor(floor), n_tiers=t))


@pytest.mark.parametrize("m,n,kind,offset,want", BTK_SEAM_CASES)
def test_batched_topk_launch_plan(m, n, kind, offset, want):
    s, b = (torch.tensor(x) for x in btk_seam_case(m, n, kind, 0))
    if offset:
        s = offset_view(s)
    kernel, lanes = t_btk.launch_plan(s, b)
    assert kernel == want
    assert lanes == {"scan_vec": n // 4, "scan_narrow": 1,
                     "scan_wide": 32}[kernel]


@pytest.mark.parametrize("m,k,b,t,offset,want", TA_SEAM_CASES)
def test_tier_assign_launch_plan(m, k, b, t, offset, want):
    ids, bounds, floor = ta_edge_case(m, k, b, t, 0)
    args = [torch.tensor(x) for x in
            (ids, t_ta.quantize_boundaries(bounds), floor)]
    if offset:
        args[0] = offset_view(args[0])
    kernel, lanes = t_ta.launch_plan(*args)
    assert kernel == want
    assert lanes == {"assign_vec": k // 4, "assign_narrow": 1,
                     "assign_wide": 32}[kernel]


def test_launch_plans_refuse_strided_inputs():
    s, b = (torch.tensor(x) for x in btk_case(4, 32, 0))
    with pytest.raises(ValueError, match="contiguous"):
        t_btk.launch_plan(s[:, ::2], b)
    with pytest.raises(ValueError, match="contiguous"):
        t_btk.launch_plan(s[:2], torch.tensor(np.zeros(4, np.float32))[::2])
    ids, bounds, floor = ta_case(4, 16, 2, 0)
    args = [torch.tensor(x) for x in
            (ids, t_ta.quantize_boundaries(bounds), floor)]
    with pytest.raises(ValueError, match="contiguous"):
        t_ta.launch_plan(args[0][:, ::2], args[1], args[2])
    with pytest.raises(ValueError, match="contiguous"):
        t_ta.launch_plan(args[0], args[1][:, ::2], args[2])
