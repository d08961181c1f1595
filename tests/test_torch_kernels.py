"""repro_torch kernels: each plain PyTorch version vs the JAX package's
Pallas kernel (interpret mode on the CPU, ``use_pallas=True``) and the
wrappers' device dispatch. The kernels themselves are held against their
plain versions on the card by tests/test_torch_cuda.py.

Tolerance: exact. Masks, counts, tiers and per-tier counts are integers;
tile maxima are elements of the input (or NEG_BIG), so they are compared
with array equality too.
"""
import numpy as np
import pytest
import torch

from repro.kernels.batched_topk import ops as j_btk
from repro.kernels.tier_assign import ops as j_ta
from repro_torch.kernels.batched_topk import ops as t_btk
from repro_torch.kernels.tier_assign import ops as t_ta
from test_torch_cuda import BTK_CASES, TA_CASES, btk_case, ta_case


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
