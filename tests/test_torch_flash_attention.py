"""The port's flash attention (its plain version, which the wrapper runs on
the CPU) against the reference's Pallas kernel in interpret mode and its
jnp oracle, on the same numpy-seeded inputs: the sweeps of
tests/test_flash_attention.py (causal float32/bfloat16, padded tails,
Sq < Skv, sliding windows, non-causal), grouped KV heads against the
reference on expanded heads, and the model's GQA attention.

Tolerance: 2e-5 in float32 and 2e-2 in bfloat16, those of the reference's
own tests (the softmax sums in another order; bfloat16 rounds the
output).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as r_ops
from repro.kernels.flash_attention import ref as r_ref
from repro_torch.kernels.flash_attention import ops as t_ops

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def make(b, sq, skv, h, hd, kvh=None, seed=0):
    rng = np.random.default_rng(seed)
    kvh = kvh or h
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32))


def to_jax(arrays, dtype):
    return [jnp.asarray(a, dtype) for a in arrays]


def to_torch(arrays, dtype):
    return [torch.tensor(a).to(dtype) for a in arrays]


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def close(a, b, tol):
    np.testing.assert_allclose(f32(a), f32(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,sq,skv,h,hd", [
    (1, 128, 128, 2, 64),
    (2, 256, 256, 1, 32),
    (1, 100, 100, 2, 64),   # padded tails
    (1, 64, 192, 2, 32),    # cross lengths (q is the suffix)
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_reference_causal(b, sq, skv, h, hd, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = make(b, sq, skv, h, hd)
    out = t_ops.flash_attention(*to_torch(arrays, tdt), causal=True)
    assert out.dtype == tdt and out.shape == (b, sq, h, hd)
    qj = to_jax(arrays, jdt)
    close(out, r_ops.flash_attention(*qj, causal=True, block_q=64,
                                     block_k=64), tol)
    close(out, r_ref.flash_attention(*qj, causal=True), tol)


@pytest.mark.parametrize("window", [16, 64])
def test_plain_sliding_window(window):
    arrays = make(1, 128, 128, 2, 32)
    out = t_ops.flash_attention(*to_torch(arrays, torch.float32),
                                causal=True, window=window)
    qj = to_jax(arrays, jnp.float32)
    close(out, r_ops.flash_attention(*qj, causal=True, window=window,
                                     block_q=32, block_k=32), 2e-5)
    close(out, r_ref.flash_attention(*qj, causal=True, window=window), 2e-5)


def test_plain_non_causal():
    arrays = make(1, 64, 64, 2, 32)
    out = t_ops.flash_attention(*to_torch(arrays, torch.float32),
                                causal=False)
    qj = to_jax(arrays, jnp.float32)
    close(out, r_ops.flash_attention(*qj, causal=False, block_q=32,
                                     block_k=32), 2e-5)
    close(out, r_ref.flash_attention(*qj, causal=False), 2e-5)


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,window", [
    (2, 64, 64, 8, 2, 32, 0),
    (1, 48, 80, 4, 1, 16, 0),   # Sq < Skv, one KV head
    (1, 96, 96, 32, 8, 64, 16),  # the serve path's head layout, windowed
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_gqa_matches_reference_on_expanded_heads(b, sq, skv, h, kvh,
                                                       hd, window, dtype):
    """KV heads are read in place: query head h sees KV head h // (H/KV),
    as the reference does on K/V repeated to H heads."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = make(b, sq, skv, h, hd, kvh=kvh, seed=3)
    out = t_ops.flash_attention(*to_torch((q, k, v), tdt), causal=True,
                                window=window)
    g = h // kvh
    qj, kj, vj = to_jax((q, np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)),
                        jdt)
    close(out, r_ref.flash_attention(qj, kj, vj, causal=True, window=window),
          tol)
    if dtype == "float32":
        close(out, r_ops.flash_attention(qj, kj, vj, causal=True,
                                         window=window, block_q=32,
                                         block_k=32), tol)


def test_plain_matches_model_grouped_attention():
    """The same function as models.attention.grouped_attention over
    consecutive positions (the reference's model path), grouped heads."""
    from repro.models import attention as r_attn
    from repro_torch.models import attention as t_attn
    q, k, v = make(2, 64, 64, 4, 32, kvh=2, seed=7)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64))
    ref = r_attn.grouped_attention(*to_jax((q, k, v), jnp.float32),
                                   jnp.asarray(pos), jnp.asarray(pos),
                                   causal=True, window=0)
    tq, tk, tv = to_torch((q, k, v), torch.float32)
    tpos = torch.tensor(pos)
    close(t_ops.flash_attention(tq, tk, tv, causal=True), ref, 2e-5)
    close(t_attn.grouped_attention(tq, tk, tv, tpos, tpos, causal=True,
                                   window=0), ref, 2e-5)


def test_all_masked_rows_average_every_key():
    """Causal with Sq > Skv: the first rows see no key and average v over
    all Skv keys, as the reference's plain version does."""
    q, k, v = make(1, 40, 24, 2, 16, seed=5)
    out = t_ops.flash_attention(*to_torch((q, k, v), torch.float32),
                                causal=True)
    close(out, r_ref.flash_attention(*to_jax((q, k, v), jnp.float32),
                                     causal=True), 2e-5)
    np.testing.assert_allclose(out[0, :16].numpy(),
                               np.broadcast_to(v[0].mean(0), (16, 2, 16)),
                               rtol=2e-5, atol=2e-5)


def test_scale_zero_means_unset_and_shape_checks():
    arrays = to_torch(make(1, 16, 16, 2, 16), torch.float32)
    torch.testing.assert_close(t_ops.flash_attention(*arrays, scale=0.0),
                               t_ops.flash_attention(*arrays, scale=0.25))
    q, k, v = arrays
    with pytest.raises(ValueError, match="KV heads"):
        t_ops.flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1),
                              v[:, :, :1].repeat(1, 1, 3, 1))
    with pytest.raises(ValueError, match="share"):
        t_ops.flash_attention(q, k.double(), v)


def test_padded_tails_follow_the_oracle_not_the_pallas_wrapper():
    """Recorded divergence (ROADMAP queue 3): the reference's wrapper pads
    Sq and Skv to its blocks and the Pallas kernel takes positions and
    the key bound from the padded lengths, so where Sq != Skv (or the
    attention is not causal) zero-padded keys take part. The port
    follows the jnp oracle, which the reference's tests hold the kernel
    to. Smallest input: one head, Sq=2, Skv=1, q = k = 1, v = 3."""
    q, k = np.ones((1, 2, 1, 8), np.float32), np.ones((1, 1, 1, 8), np.float32)
    v = np.full((1, 1, 1, 8), 3.0, np.float32)
    port = t_ops.flash_attention(*to_torch((q, k, v), torch.float32))
    oracle = r_ref.flash_attention(*to_jax((q, k, v), jnp.float32))
    pallas = r_ops.flash_attention(*to_jax((q, k, v), jnp.float32))
    close(port, oracle, 2e-5)
    np.testing.assert_allclose(f32(port)[0, :, 0, 0], [3.0, 3.0], rtol=1e-6)
    np.testing.assert_allclose(f32(pallas)[0, :, 0, 0], [3.0, 2.8325784],
                               rtol=1e-5)


@pytest.mark.parametrize("b,sq,skv,h,kvh,window", [
    (1, 64, 64, 2, 2, 0),     # causal
    (1, 48, 80, 4, 2, 0),     # GQA, Sq < Skv, padded tails
    (1, 96, 96, 6, 2, 32),    # starcoder2-3b's grouping (3 per KV head), windowed
    (2, 8, 8, 2, 1, 0),       # small S
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_reference_at_head_dim_128(b, sq, skv, h, kvh, window,
                                                 dtype):
    """Head dim 128, which the kernel now takes (yi-9b, starcoder2-3b,
    command-r-plus-104b, grok-1, pixtral-12b): the plain version against
    the jnp oracle and the Pallas kernel in interpret mode on K/V expanded
    to H heads."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = make(b, sq, skv, h, 128, kvh=kvh, seed=11)
    out = t_ops.flash_attention(*to_torch((q, k, v), tdt), causal=True,
                                window=window)
    assert out.dtype == tdt and out.shape == (b, sq, h, 128)
    g = h // kvh
    qj, kj, vj = to_jax((q, np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)),
                        jdt)
    close(out, r_ref.flash_attention(qj, kj, vj, causal=True, window=window),
          tol)
    if sq == skv:  # the Pallas wrapper pads ragged tails (see below)
        close(out, r_ops.flash_attention(qj, kj, vj, causal=True,
                                         window=window, block_q=32,
                                         block_k=32), tol)


def test_plain_non_causal_at_head_dim_128():
    arrays = make(1, 64, 64, 2, 128, seed=12)
    out = t_ops.flash_attention(*to_torch(arrays, torch.float32),
                                causal=False)
    qj = to_jax(arrays, jnp.float32)
    close(out, r_ops.flash_attention(*qj, causal=False, block_q=32,
                                     block_k=32), 2e-5)
    close(out, r_ref.flash_attention(*qj, causal=False), 2e-5)


def test_head_dims_of_the_build_cover_every_config():
    """Every (q/k, v) head-dim pair of the ten configs (full and reduced)
    is one the kernel is built for: head_dim twice for grouped-query
    attention, (nope + rope, v_head_dim) for MLA, (192, 128) at full
    width and (24, 16) reduced."""
    from repro_torch import configs
    pairs = set()
    for arch in configs.ARCHS:
        for reduced in (False, True):
            cfg = configs.get_config(arch, reduced=reduced)
            if cfg.use_mla:
                pairs.add((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                           cfg.v_head_dim))
            elif cfg.n_heads:
                pairs.add((cfg.head_dim, cfg.head_dim))
    assert pairs <= set(t_ops.HEAD_DIMS)
    assert {(128, 128), (192, 128), (24, 16)} <= pairs


# ---------------------------------------------------------------------------
# backward_plan: how the backward's dK/dV launch cuts each query-head group
# ---------------------------------------------------------------------------

# the most float32 dK/dV partials a training shape may ask for
SCRATCH_LIMIT = 128 << 20


def _plan_archs():
    from repro_torch import configs
    return [a for a in configs.ARCHS if configs.get_config(a).n_heads]


def _plan_heads(cfg):
    """(H, KV, hd, hd_v) of a config's training launch: MLA's K and V per
    head at (q/k, v) head dims (nope + rope, v_head_dim), GQA's at hd."""
    if cfg.use_mla:
        return (cfg.n_heads, cfg.n_heads,
                cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
    return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim


@pytest.mark.parametrize("arch", _plan_archs())
@pytest.mark.parametrize("batch", [4, 8])
def test_backward_plan_invariants_at_every_config(arch, batch):
    """At each config's full width and batch x 1024 tokens (MLA's at its
    head-dim pair): each launch's layout as the kernel is compiled
    (BWD_LAYOUTS), its grid and shared memory; 1 <= split <= g with
    split | g (even parts); the dK/dV grid is the unsplit one times split;
    the group is split exactly when that grid is below BWD_FILL; the
    partials (dK's and dV's, float32) stay within SCRATCH_LIMIT."""
    from repro_torch import configs
    h, kvh, hd, hd_v = _plan_heads(configs.get_config(arch))
    plan = t_ops.backward_plan(batch, h, kvh, 1024, 1024, hd, hd_v)
    g = h // kvh
    for launch in ("dq", "dkdv"):
        bn, ps, rs, nb = t_ops.BWD_LAYOUTS[launch][hd]
        got = plan[launch]
        assert (got["tile_rows"], got["stages"], got["tma_slots"],
                got["handoffs"]) == (bn, ps, rs, nb)
        assert (got["rows"], got["warpgroups"], got["threads"]) == (64, 2,
                                                                    384)
        assert got["smem_bytes"] == t_ops.backward_smem(launch, hd, hd_v)
        assert got["smem_bytes"] <= t_ops.SMEM_LIMIT
    keys = plan["dkdv"]["rows"]
    base = kvh * batch * -(-1024 // keys)
    assert plan["keys"] == keys
    assert plan["dq"]["grid"] == (h, batch, -(-1024 // plan["dq"]["rows"]))
    assert plan["dkdv"]["grid"] == (kvh * plan["split"], batch,
                                    -(-1024 // keys))
    assert 1 <= plan["split"] <= g and g % plan["split"] == 0
    assert plan["blocks"] == base * plan["split"]
    assert plan["scratch_bytes"] <= SCRATCH_LIMIT
    if base >= t_ops.BWD_FILL or g == 1:
        assert plan["split"] == 1 and plan["scratch_bytes"] == 0
    else:
        assert plan["split"] > 1
        assert plan["scratch_bytes"] == (plan["split"] * 4 * batch * 1024
                                         * kvh * (hd + hd_v))


def test_backward_plan_at_mla_head_dims():
    """deepseek-v2's training launch, q and k (8, 1024, 128, 192), v (8,
    1024, 128, 128): 64 query rows a dq block and 32-key tiles, 64 keys a
    dK/dV block and 32-query tiles, each in two stages, 16,384 dK/dV
    blocks, no split; a
    batch-1 call at (24, 16) whose group is split counts dK's and dV's
    partials at their own head dims."""
    plan = t_ops.backward_plan(8, 128, 128, 1024, 1024, 192, 128)
    assert (plan["keys"], plan["split"], plan["blocks"],
            plan["scratch_bytes"]) == (64, 1, 16384, 0)
    assert plan["dq"]["rows"] == 64 and plan["dq"]["tile_rows"] == 32
    assert plan["dq"]["grid"] == (128, 8, 16)
    assert (plan["dkdv"]["tile_rows"], plan["dkdv"]["stages"]) == (32, 2)
    assert plan["dq"]["smem_bytes"] == 214_128
    assert plan["dkdv"]["smem_bytes"] == 214_640
    plan = t_ops.backward_plan(1, 4, 1, 100, 100, 24, 16)
    assert plan["keys"] == 64 and plan["split"] == 4
    assert plan["scratch_bytes"] == 4 * 4 * 100 * 1 * (24 + 16)
    assert t_ops.backward_plan(1, 4, 1, 100, 100, 24)["scratch_bytes"] == \
        4 * 4 * 100 * 1 * (24 + 24)


def test_backward_plan_leaves_a_full_grid_unsplit():
    """llama3.2-1b's training shape (phase 17b): 8 KV heads x 8 x 16 key
    blocks = 1,024 dK/dV blocks fill the 132 SMs, so no split and no
    scratch; dq holds 64 query rows a block and streams 32-key tiles."""
    plan = t_ops.backward_plan(8, 32, 8, 1024, 1024, 64)
    assert (plan["keys"], plan["split"], plan["blocks"],
            plan["scratch_bytes"]) == (64, 1, 1024, 0)
    assert plan["dq"]["tile_rows"] == 32 and plan["dq"]["grid"] == (32, 8, 16)
    assert plan["blocks"] >= t_ops.BWD_FILL >= t_ops.SMS


@pytest.mark.parametrize("batch,split", [(4, 6), (8, 3)])
def test_backward_plan_splits_the_head_dim_128_group(batch, split):
    """q (batch, 1024, 24, 128), k and v (batch, 1024, 2, 128): 2 x batch
    x 16 blocks of 64 keys leave the card short, so the 12 heads of a
    group are cut into the fewest even parts that reach BWD_FILL; 768
    blocks and 48 MiB of float32 partials."""
    plan = t_ops.backward_plan(batch, 24, 2, 1024, 1024, 128)
    assert plan["keys"] == plan["dkdv"]["rows"] == 64
    assert plan["split"] == split and plan["blocks"] == 768
    assert plan["scratch_bytes"] == split * 2 * 4 * batch * 1024 * 2 * 128
    assert plan["scratch_bytes"] <= SCRATCH_LIMIT


def test_backward_plan_small_grids():
    """A batch-1 call with one KV head splits its whole group when no
    divisor reaches BWD_FILL; a group of one head, or an empty one, is
    never split; a grid just short of BWD_FILL takes the smallest divisor
    that reaches it."""
    assert t_ops.backward_plan(1, 12, 1, 200, 200, 64)["split"] == 12
    assert t_ops.backward_plan(1, 6, 1, 150, 150, 32)["split"] == 6
    assert t_ops.backward_plan(1, 4, 4, 90, 33, 16)["split"] == 1
    assert t_ops.backward_plan(1, 4, 4, 0, 0, 64)["split"] == 1
    # 512 blocks of 64 keys: 2 parts of the 12 heads reach 1,024
    plan = t_ops.backward_plan(1, 12, 1, 32_768, 32_768, 64)
    assert plan["split"] == 2 and plan["blocks"] == 1024
    assert plan["scratch_bytes"] == 2 * 2 * 4 * 32_768 * 64
    # the same at head dim 128: every dK/dV block holds 64 keys
    plan = t_ops.backward_plan(1, 12, 1, 32_768, 32_768, 128)
    assert plan["split"] == 2 and plan["blocks"] == 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pair,capped", [
    (pair, capped) for pair in t_ops.HEAD_DIMS for capped in (False, True)
    if not capped or pair[0] == pair[1]])
def test_backward_layout_fits_shared_memory(pair, capped, dtype):
    """Each launch's block, at every head-dim pair the kernel is built for,
    in float32 and bfloat16, capped or not (where the pair has a capped
    build), takes at most the 227 KB of shared memory a block may have
    (one block an SM); bfloat16 takes less than float32 (its tiles land
    in half the bytes and carry no low parts). MLA's pairs are built
    without the cap."""
    hd, hd_v = pair
    plan = t_ops.backward_plan(2, 8, 2, 300, 300, hd, hd_v, dtype=dtype,
                               softcap=30.0 if capped else 0.0)
    for launch in ("dq", "dkdv"):
        got = plan[launch]
        assert got["smem_bytes"] <= t_ops.SMEM_LIMIT
        if dtype == torch.bfloat16:
            assert got["smem_bytes"] < t_ops.backward_smem(launch, hd, hd_v)


def _tiles(plan, sq, skv):
    """The row ranges the plan's launches cover: each dq block's and dK/dV
    block's resident row groups (64 rows each) and, for each launch, its
    streamed tiles over the other side (dq: keys; dK/dV: queries)."""
    out = {}
    for launch, n, other in (("dq", sq, skv), ("dkdv", skv, sq)):
        got = plan[launch]
        z, groups = got["grid"][2], got["rows"] // 64
        resident = [(64 * (blk * groups + c), 64 * (blk * groups + c) + 64)
                    for blk in range(z) for c in range(groups)]
        bn = got["tile_rows"]
        streamed = [(t * bn, t * bn + bn) for t in range(-(-other // bn))]
        out[launch] = (resident, n, streamed, other)
    return out


@pytest.mark.parametrize("pair", t_ops.HEAD_DIMS)
@pytest.mark.parametrize("sq,skv", [(1024, 1024), (90, 33), (130, 333),
                                    (1, 65), (1500, 448)])
def test_backward_tiles_cover_every_row_once(pair, sq, skv):
    """Every query row is one dq warpgroup's resident row and falls in
    exactly one of the dK/dV launch's streamed query tiles; every key is
    one dK/dV warpgroup's and falls in exactly one of dq's key tiles. The
    tiles past the ragged end cover nothing real (the kernels mask them):
    a block's spare warpgroup, or the rows of the last tile past the end."""
    hd, hd_v = pair
    plan = t_ops.backward_plan(2, 8, 2, sq, skv, hd, hd_v)
    for launch, (resident, n, streamed, other) in _tiles(plan, sq,
                                                         skv).items():
        for ranges, size in ((resident, n), (streamed, other)):
            seen = np.zeros(size, dtype=int)
            for lo, hi in ranges:
                seen[lo:min(hi, size)] += 1
            assert (seen == 1).all(), (launch, size)
        per_block = plan[launch]["rows"]
        assert resident[-1][1] - per_block < n <= resident[-1][1]
        assert streamed[-1][0] < other <= streamed[-1][1]


def test_backward_plan_is_a_pure_function_of_the_shape():
    """The same shape gives the same plan, call after call and whatever
    the launch counters say; the cap changes nothing of it, the type only
    the shared memory."""
    args = (8, 128, 128, 1024, 1024, 192, 128)
    first = t_ops.backward_plan(*args)
    t_ops.bwd_launches += 1
    try:
        assert t_ops.backward_plan(*args) == first
    finally:
        t_ops.bwd_launches -= 1
    assert t_ops.backward_plan(*args, softcap=30.0) == first
    half = t_ops.backward_plan(*args, dtype=torch.bfloat16)
    for launch in ("dq", "dkdv"):
        assert {k: v for k, v in half[launch].items() if k != "smem_bytes"} \
            == {k: v for k, v in first[launch].items() if k != "smem_bytes"}
    assert {k: half[k] for k in ("keys", "split", "blocks")} == \
        {k: first[k] for k in ("keys", "split", "blocks")}


# ---------------------------------------------------------------------------
# soft-capping: the reference caps in its model attention, not its kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [30.0, 5.0])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("b,sq,skv,h,kvh,window", [
    (2, 48, 48, 6, 2, 0),     # grouped, causal
    (1, 40, 72, 4, 4, 24),    # Sq < Skv under a window
])
def test_plain_softcap_matches_model_grouped_attention(b, sq, skv, h, kvh,
                                                       window, hd, cap):
    """``reference(..., softcap=)`` and ``reference_lse`` against the
    reference's ``models.attention.grouped_attention`` with ``softcap``
    (and the log-sum-exp of its capped, masked logits), q scaled so the
    logits reach ±50 and the cap bites."""
    from repro.models import attention as r_attn
    q, k, v = make(b, sq, skv, h, hd, kvh=kvh, seed=13)
    q = q * 4.0 * np.float32(hd) ** 0.25
    qpos = np.broadcast_to(np.arange(skv - sq, skv, dtype=np.int32), (b, sq))
    kpos = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv))
    qj, kj, vj = to_jax((q, k, v), jnp.float32)
    kw = dict(causal=True, window=window)
    want = r_attn.grouped_attention(qj, kj, vj, jnp.asarray(qpos),
                                    jnp.asarray(kpos), softcap=cap, **kw)
    tq, tk, tv = to_torch((q, k, v), torch.float32)
    got = t_ops.flash_attention(tq, tk, tv, softcap=cap, **kw)
    close(got, want, 2e-5)
    close(t_ops.reference(tq, tk, tv, softcap=cap, **kw), want, 2e-5)
    # the reference's capped, masked logits (B, KV, g, Sq, Skv), their
    # log-sum-exp laid out (B, H, Sq) as the kernel writes it
    g = h // kvh
    qg = (qj / np.sqrt(hd)).reshape(b, sq, kvh, g, hd)
    logits = r_attn._softcap(jnp.einsum("bqkgd,bskd->bkgqs", qg, kj), cap)
    ok = r_attn.mask_ok(jnp.asarray(qpos), jnp.asarray(kpos), True, window)
    logits = jnp.where(ok[:, None, None], logits, r_attn.BIG_NEG)
    lse = jax.nn.logsumexp(logits, axis=-1).reshape(b, h, sq)
    close(t_ops.reference_lse(tq, tk, tv, softcap=cap, **kw), lse, 2e-5)
    assert float(np.abs(np.asarray(logits)).max()) > cap * 0.99
    uncapped = t_ops.reference(tq, tk, tv, **kw)
    assert float((uncapped - got).abs().max()) > 1e-3


def test_softcap_zero_or_negative_is_no_cap():
    arrays = to_torch(make(1, 32, 32, 2, 16, seed=14), torch.float32)
    out = t_ops.flash_attention(*arrays)
    for cap in (0.0, -1.0, None):
        torch.testing.assert_close(t_ops.flash_attention(*arrays, softcap=cap),
                                   out, rtol=0, atol=0)


def test_softcap_gradient_on_the_cpu_is_autograd_of_the_plain_version():
    """On the CPU the capped forward is the plain version, which autograd
    differentiates (the card's capped backward is not written yet)."""
    q, k, v = (x.requires_grad_(True) for x in to_torch(
        make(1, 24, 24, 4, 16, kvh=2, seed=15), torch.float32))
    out = t_ops.flash_attention(q * 4, k, v, softcap=5.0)
    gq, gk, gv = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert all(bool(torch.isfinite(x).all()) and bool(x.abs().any())
               for x in (gq, gk, gv))


# (b, sq, skv, h, kvh, hd, window, softcap, q scale): keys past one
# KV_CHUNK of chunked_attention's scan; the 4096-key window over 4608 keys
# (the card's long-key case, fewer heads); a cap of 5 that bites past one
# chunk; Sq < Skv over three chunks under a window of 1500
LONG_KEY_CASES = [(1, 4608, 4608, 2, 1, 128, 4096, 0.0, 1.0),
                  (1, 1300, 1300, 4, 2, 64, 0, 5.0, 8.0),
                  (1, 700, 2200, 4, 2, 128, 1500, 5.0, 8.0)]


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,window,cap,qs", LONG_KEY_CASES)
def test_long_keys_match_chunked_attention(b, sq, skv, h, kvh, hd, window,
                                           cap, qs):
    """flash_attention's long-key cases against the model's
    ``chunked_attention`` (the reference's online-softmax scan over key
    chunks, which the kernel replaces on long prompts) within 2e-5 in
    float32, the query positions the suffix of the keys' as the kernel
    places them."""
    from repro_torch.models import attention as t_attn
    q, k, v = make(b, sq, skv, h, hd, kvh=kvh, seed=16)
    tq, tk, tv = to_torch((q * qs, k, v), torch.float32)
    assert skv > t_attn.KV_CHUNK
    kw = dict(causal=True, window=window, softcap=cap)
    qp = torch.arange(skv - sq, skv).expand(b, sq)
    kp = torch.arange(skv).expand(b, skv)
    close(t_ops.flash_attention(tq, tk, tv, **kw),
          t_attn.chunked_attention(tq, tk, tv, qp, kp, **kw), 2e-5)


# ---------------------------------------------------------------------------
# unequal q/k and v head dims (MLA: deepseek-v2's 192 and 128)
# ---------------------------------------------------------------------------

def make_mla(b, sq, skv, h, hd, hd_v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, h, hd_v)).astype(np.float32))


# (b, sq, skv, h, hd, hd_v, causal, window): deepseek's pair causal, ragged
# Sq < Skv, windowed, non-causal, rows with no key; the reduced config's
MLA_CASES = [(1, 96, 96, 2, 192, 128, True, 0),
             (1, 40, 100, 2, 192, 128, True, 0),
             (2, 70, 70, 2, 192, 128, True, 24),
             (1, 64, 64, 1, 192, 128, False, 0),
             (1, 40, 24, 2, 192, 128, True, 0),
             (2, 33, 33, 4, 24, 16, True, 0)]


@pytest.mark.parametrize("b,sq,skv,h,hd,hd_v,causal,window", MLA_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_unequal_head_dims_match_reference(b, sq, skv, h, hd, hd_v,
                                                 causal, window, dtype):
    """The plain version at (hd, hd_v) against the reference's jnp oracle
    (any head dims: it contracts q with k and the probabilities with v)
    and, in float32, the model's grouped_attention at the same scale; the
    output takes v's head dim."""
    from repro_torch.models import attention as t_attn
    jdt, tdt, tol = DTYPES[dtype]
    arrays = make_mla(b, sq, skv, h, hd, hd_v, seed=sq + skv)
    scale = 1.0 / np.sqrt(hd)
    tq, tk, tv = to_torch(arrays, tdt)
    out = t_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                scale=scale)
    assert out.dtype == tdt and out.shape == (b, sq, h, hd_v)
    close(out, r_ref.flash_attention(*to_jax(arrays, jdt), causal=causal,
                                     window=window, scale=scale), tol)
    if dtype == "float32":
        qp = torch.arange(skv - sq, skv).expand(b, sq)
        kp = torch.arange(skv).expand(b, skv)
        close(out, t_attn.grouped_attention(tq, tk, tv, qp, kp,
                                            causal=causal, window=window,
                                            scale=scale), tol)
        lse = t_ops.reference_lse(tq, tk, tv, causal=causal, window=window,
                                  scale=scale)
        assert lse.shape == (b, h, sq) and bool(torch.isfinite(lse).all())


def test_unequal_head_dims_shape_checks_and_gradient():
    """v may differ from q and k in its last dim alone; on the CPU the
    plain version's gradient is autograd's, and the backward's kernel
    takes no CPU tensor."""
    q, k, v = to_torch(make_mla(1, 8, 8, 2, 24, 16, seed=3), torch.float32)
    with pytest.raises(ValueError, match="do not fit"):
        t_ops.flash_attention(q, k[..., :16], v)
    with pytest.raises(ValueError, match="do not fit"):
        t_ops.flash_attention(q, k, v[:, :4])
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    out = t_ops.flash_attention(q, k, v)
    gq, gk, gv = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert gv.shape == v.shape and all(bool(x.abs().any())
                                       for x in (gq, gk, gv))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        t_ops.backward(q, k, v, out, torch.zeros((1, 2, 8)),
                       torch.ones_like(out))
