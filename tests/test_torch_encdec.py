"""The port's encoder-decoder path (whisper-base) and vision-patch frontend
(pixtral-12b) against the reference's ``repro.models``, at reduced size
with the reference's weights carried across by ``from_reference_params``
and the inputs (tokens, frame and patch embeddings) from numpy seeds:
``sinusoidal_pos``; ``encode``, ``forward``, ``prefill`` and
``decode_step`` on both routes, with the caches' cross-attention K/V;
prefill then decode against the port's own forward; ``lm_loss`` and its
gradients; ``from_reference_train_state``, ``train_step`` with
microbatches and a bit-equal resume through ``train_loop``; the learned
positions' clamp past ``decoder_len``; the kernel's plain version at
non-causal Sq < Skv and Sq > Skv; the guards (cross-attention on the
kernel only under its non-causal mask, a prompt shorter than its patch
prefix).

Tolerances, as tests/test_torch_models.py and tests/test_torch_train.py
state them: logits within 2e-5 (float32 products and softmax sums in
another order on another backend); prefill and decode against the
forward within 2e-3 relative and 3e-4 absolute (the reference's own
tests/test_decode.py); the loss within rtol 1e-5 and each gradient
within 1e-5 of its largest magnitude; ``sinusoidal_pos`` within 1e-6 in
its first rows, and in row p within 1e-6 + p · 2^-23 (the two
libraries' float32 ``exp`` of the inverse frequencies differ by an ulp,
which an angle of p radians multiplies).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import lm as r_lm
from repro.runtime import steps as r_steps
from repro_torch import configs as t_configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline as t_pipe
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import lm as t_lm
from repro_torch.optim import adamw as t_adamw
from repro_torch.runtime import steps as t_steps
from repro_torch.runtime import train_loop

TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["whisper-base", "pixtral-12b"]
B, S, S_ENC = 2, 20, 24  # pixtral's sequences; whisper's decoder is 16 long


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def ref_setup(arch, seed=0):
    cfg = r_configs.get_config(arch, reduced=True)
    params = r_lm.init_params(cfg, jax.random.PRNGKey(seed))
    tcfg = t_configs.get_config(arch, reduced=True)
    return cfg, params, tcfg, t_lm.from_reference_params(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")


def batch_for(cfg, b=B, seed=3):
    """Tokens and, by the config, frame or patch embeddings from a numpy
    seed: whisper's decoder takes ``decoder_len`` tokens over S_ENC
    frames, pixtral S tokens whose first n_patches are replaced."""
    rng = np.random.default_rng(seed)
    s = cfg.decoder_len if cfg.is_encoder_decoder else S
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
           "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (b, S_ENC, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def enc_len(batch):
    return batch["frames"].shape[1] if "frames" in batch else 0


def leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def rel_close(got, want, frac, what, scale=None):
    """|got − want| <= frac · max|want| (or frac · ``scale``)
    elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if scale is None:
        scale = float(np.abs(want).max())
    lim = frac * max(scale, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= lim, f"{what}: max abs diff {err} > {lim}"


def grads_close(got, want, frac, what):
    """Each leaf of ``got`` within ``frac`` of its largest magnitude in
    ``want`` (trees of the same paths), but an attention's key bias
    ``bk`` within ``frac`` of its value bias ``bv``'s: a shift of every
    key adds the same q·b to each logit of a row, which the softmax
    removes, so its exact gradient is 0 and both sides hold float noise
    of their own sums."""
    want = dict(leaves_with_paths(want))
    for path, g in leaves_with_paths(got):
        w = want[path].numpy()
        assert g.shape == w.shape, path
        scale = None
        if path[-1] == "bk":
            scale = float(np.abs(want[path[:-1] + ("bv",)].numpy()).max())
            assert float(np.abs(w).max()) <= frac * scale, path
        rel_close(g.numpy(), w, frac, f"{what} {path}", scale)


# ---------------------------------------------------------------------------
# sinusoidal_pos, parameters, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,d", [(1500, 512), (24, 64), (7, 2), (5, 3),
                                   (1, 16)])
def test_sinusoidal_pos_matches_reference(seq, d):
    """[sin | cos] concatenated over exp(-i ln 10000 / max(D/2 - 1, 1)):
    whisper-base's full 1500 x 512, the reduced encoder's, D = 2 (the
    divisor's floor of 1) and an odd D (its last column dropped).

    Row p within 1e-6 + p · 2^-23: XLA's float32 ``exp`` on the CPU is not
    correctly rounded (at D = 512, 21 of its 256 inverse frequencies
    differ by an ulp from torch's, which match the float64 value rounded
    in all but one), and an angle p · inv carries that ulp p times; the
    first rows (p ≤ 8) are held within 1e-6 outright, and the inverse
    frequencies (row 1's sines, below an angle of 1) within 2 ulps."""
    got = t_common.sinusoidal_pos(seq, d)
    want = np.asarray(r_common.sinusoidal_pos(seq, d))
    assert got.dtype == torch.float32 and got.shape == want.shape
    diff = np.abs(got.numpy().astype(np.float64) - want)
    rows = np.arange(seq)[:, None]
    assert (diff <= 1e-6 + rows * 2.0 ** -23).all(), float(diff.max())
    assert float(diff[:9].max(initial=0.0)) <= 1e-6
    half = d // 2
    if seq > 1:
        close(got[1, :half], want[1, :half], rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(got[0, :half].numpy(), 0.0)
    np.testing.assert_array_equal(got[0, half:2 * half].numpy(), 1.0)
    assert t_common.sinusoidal_pos(seq, d, torch.bfloat16).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("arch", sorted(t_configs.ARCHS))
def test_every_arch_builds_params_and_caches(arch):
    """init_params, param_count and init_cache run for each of the ten
    configs (reduced): the counts equal the reference's and the drawn
    tree's, and a cross-attention layer's cache holds cross_k / cross_v
    of (B, enc_len, KV, hd)."""
    cfg = t_configs.get_config(arch, reduced=True)
    params = t_lm.init_params(cfg, seed=0, device="cpu")
    n = sum(x.numel() for x in t_adamw.tree_leaves(params))
    assert n == t_lm.param_count(cfg) == r_lm.param_count(
        r_configs.get_config(arch, reduced=True))
    cache = t_lm.init_cache(cfg, 2, 8, device="cpu", enc_len=5)
    for spec, group in zip(cfg.layers, cache["groups"]):
        for lc in group:
            assert ("cross_k" in lc) == spec.cross_attn
            if spec.cross_attn:
                want = (2, 5, cfg.n_kv_heads, cfg.head_dim)
                assert lc["cross_k"].shape == lc["cross_v"].shape == want
                assert not bool(lc["cross_k"].any())


def test_full_param_counts_equal_reference():
    """whisper-base 70,924,800 and pixtral-12b 12,247,782,400, as the
    reference counts them; whisper's learned positions are
    (decoder_len, d_model) = (448, 512) and its encoder 6 layers."""
    want = {"whisper-base": 70_924_800, "pixtral-12b": 12_247_782_400}
    for arch, n in want.items():
        cfg = t_configs.get_config(arch)
        assert t_lm.param_count(cfg) == n == r_lm.param_count(
            r_configs.get_config(arch))
    shapes = t_lm.param_shapes(t_configs.get_config("whisper-base"))
    assert shapes["pos_embed"] == (448, 512)
    assert len(shapes["enc"]) == 1 and len(shapes["enc"][0]) == 6
    assert shapes["dec"][0][0]["cross"]["wk"] == (512, 8, 64)
    assert list(shapes) == ["embed", "final_norm", "pos_embed", "enc",
                            "enc_norm", "dec"]


def test_abstract_params_and_init_match_reference_layout():
    """Leaf by leaf, abstract_params (bfloat16 parameters) against the
    reference's jax.eval_shape, and init_params' drawn shapes, for
    whisper's encoder, cross-attention and learned positions; the
    learned positions are a fan-in normal over d_model."""
    cfg = r_configs.get_config("whisper-base", reduced=True).with_dtypes(
        "bfloat16", "bfloat16")
    tcfg = t_configs.get_config("whisper-base", reduced=True).with_dtypes(
        "bfloat16", "bfloat16")
    ours = t_lm.abstract_params(tcfg)
    drawn = t_lm.init_params(tcfg, seed=1, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            r_lm.abstract_params(cfg)):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        stacked = keys[0] in ("enc", "dec")
        for tree in (ours, drawn):
            node = tree
            for k in keys[:2] if stacked else keys:
                node = node[k]
            if stacked:
                assert len(node) == leaf.shape[0]
                node = node[0]
                for k in keys[2:]:
                    node = node[k]
            want = leaf.shape[1:] if stacked else leaf.shape
            assert (tuple(node.shape), str(node.dtype)[6:]) == \
                (want, str(leaf.dtype)), keys
    pos = drawn["pos_embed"].to(torch.float32)
    assert float(pos.abs().max()) <= 2 / np.sqrt(tcfg.d_model) * 1.01


# ---------------------------------------------------------------------------
# encode / forward / prefill / decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
def test_encode_matches_reference(use_kernel):
    cfg, params, tcfg, tparams = ref_setup("whisper-base")
    frames = batch_for(cfg)["frames"]
    want = r_lm.encode(params, cfg, jnp.asarray(frames))
    got = t_lm.encode(tparams, tcfg, torch.tensor(frames),
                      use_kernel=use_kernel)
    assert got.shape == (B, S_ENC, tcfg.d_model)
    close(got, want)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, use_kernel):
    cfg, params, tcfg, tparams = ref_setup(arch)
    batch = batch_for(cfg)
    ref, r_aux = r_lm.forward(params, cfg, as_jax(batch))
    got, aux = t_lm.forward(tparams, tcfg, as_torch(batch),
                            use_kernel=use_kernel)
    assert got.dtype == torch.float32
    close(got, ref)
    assert float(aux) == float(r_aux) == 0.0


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, use_kernel):
    """Logits of the prefill (whisper: the encoder run and the cross K/V
    written; pixtral: the patch prefix blended) and of each decode step
    against the reference's; then every layer's KV cache (positions
    exactly, K/V within TOL) and whisper's cross_k / cross_v."""
    cfg, params, tcfg, tparams = ref_setup(arch)
    batch = batch_for(cfg)
    toks = batch["tokens"]
    s, t0 = toks.shape[1], 12
    pre = dict(batch, tokens=toks[:, :t0])
    r_cache = r_lm.init_cache(cfg, B, s + 1, enc_len=enc_len(batch))
    r_logits, r_cache = r_lm.prefill(params, cfg, as_jax(pre), r_cache)
    t_cache = t_lm.init_cache(tcfg, B, s + 1, device="cpu",
                              enc_len=enc_len(batch))
    t_logits, t_cache = t_lm.prefill(tparams, tcfg, as_torch(pre), t_cache,
                                     use_kernel=use_kernel)
    close(t_logits, r_logits)
    for t in range(t0, s):
        r_logits, r_cache = r_lm.decode_step(params, cfg,
                                             jnp.asarray(toks[:, t]), r_cache)
        t_logits, t_cache = t_lm.decode_step(tparams, tcfg,
                                             torch.tensor(toks[:, t]),
                                             t_cache)
        close(t_logits, r_logits)
    assert t_cache["pos"] == int(r_cache["pos"]) == s
    for t_group, r_group in zip(t_cache["groups"], r_cache["groups"]):
        for li, lc in enumerate(t_group):
            assert lc.keys() == r_group.keys()
            np.testing.assert_array_equal(lc["kv"].pos.numpy(),
                                          np.asarray(r_group["kv"].pos[li]))
            close(lc["kv"].k, r_group["kv"].k[li])
            close(lc["kv"].v, r_group["kv"].v[li])
            if cfg.is_encoder_decoder:
                close(lc["cross_k"], r_group["cross_k"][li])
                close(lc["cross_v"], r_group["cross_v"][li])
                assert lc["cross_k"].shape[1] == S_ENC


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch, use_kernel):
    """The port against itself, as tests/test_decode.py holds the
    reference: the prefill's last logits and each decode step's against
    the forward's at that position."""
    tcfg = t_configs.get_config(arch, reduced=True)
    params = t_lm.init_params(tcfg, seed=1, device="cpu")
    batch = as_torch(batch_for(tcfg))
    toks = batch["tokens"]
    s, t0 = toks.shape[1], 10
    full, _ = t_lm.forward(params, tcfg, batch, use_kernel=use_kernel)
    cache = t_lm.init_cache(tcfg, B, s + 1, device="cpu",
                            enc_len=enc_len(batch))
    logits, cache = t_lm.prefill(params, tcfg, dict(batch,
                                                    tokens=toks[:, :t0]),
                                 cache, use_kernel=use_kernel)
    close(logits, full[:, t0 - 1], rtol=2e-3, atol=2e-4)
    for t in range(t0, s):
        logits, cache = t_lm.decode_step(params, tcfg, toks[:, t], cache)
        close(logits, full[:, t], rtol=2e-3, atol=3e-4)


def test_learned_positions_clamp_past_decoder_len():
    """Decode steps at positions 16 and 19 of reduced whisper-base, whose
    table has decoder_len = 16 rows: the reference's gather clamps the
    index to row 15, and the port's logits equal its logits; the
    embedding read is row 15's exactly."""
    cfg, params, tcfg, tparams = ref_setup("whisper-base")
    batch = batch_for(cfg)
    toks = batch["tokens"]
    assert toks.shape[1] == cfg.decoder_len == 16
    r_cache = r_lm.init_cache(cfg, B, 24, enc_len=S_ENC)
    r_logits, r_cache = r_lm.prefill(params, cfg, as_jax(batch), r_cache)
    t_cache = t_lm.init_cache(tcfg, B, 24, device="cpu", enc_len=S_ENC)
    t_logits, t_cache = t_lm.prefill(tparams, tcfg, as_torch(batch),
                                     t_cache)
    close(t_logits, r_logits)
    feed = np.random.default_rng(9).integers(0, cfg.vocab_size, (4, B))
    for tok in feed:
        r_logits, r_cache = r_lm.decode_step(params, cfg, jnp.asarray(tok),
                                             r_cache)
        t_logits, t_cache = t_lm.decode_step(tparams, tcfg,
                                             torch.tensor(tok), t_cache)
        close(t_logits, r_logits)
    assert t_cache["pos"] == 20
    pos = torch.tensor([[15, 16, 19, 448]])
    x = t_lm._embed_tokens(tparams, tcfg, torch.zeros((1, 4), dtype=int),
                           pos)
    row = tparams["embed"][0] + tparams["pos_embed"][15]
    for i in range(4):
        assert torch.equal(x[0, i], row)


def test_patch_prefix_replaces_the_first_positions_and_guards_length():
    """pixtral's blend: the forward's logits do not depend on the tokens
    under the patch prefix, and a prompt shorter than n_patches raises
    ValueError naming both lengths (the reference fails there)."""
    tcfg = t_configs.get_config("pixtral-12b", reduced=True)
    params = t_lm.init_params(tcfg, seed=2, device="cpu")
    batch = as_torch(batch_for(tcfg))
    a, _ = t_lm.forward(params, tcfg, batch)
    other = batch["tokens"].clone()
    other[:, :tcfg.n_patches] = (other[:, :tcfg.n_patches] + 7) % 256
    b, _ = t_lm.forward(params, tcfg, dict(batch, tokens=other))
    assert torch.equal(a, b)
    short = dict(batch, tokens=batch["tokens"][:, :tcfg.n_patches - 1])
    cache = t_lm.init_cache(tcfg, B, S, device="cpu")
    with pytest.raises(ValueError, match=r"7 tokens .* its 8 patch"):
        t_lm.prefill(params, tcfg, short, cache)
    with pytest.raises(ValueError, match=r"7 tokens .* its 8 patch"):
        t_lm.forward(params, tcfg, short)


def test_cross_attention_on_the_kernel_only_without_a_mask():
    """attend(cross=True) routes to the kernel under a non-causal,
    window-0 mask (the kernel's positions are read by no mask there) and
    raises under a causal or windowed one."""
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((1, 5, 2, 16)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((1, 9, 2, 16)), dtype=torch.float32)
    qp = torch.arange(5)[None]
    kp = torch.arange(9)[None]
    out = t_attn.attend(q, k, k, qp, kp, causal=False, window=0, flash=True,
                        cross=True)
    close(out, t_attn.grouped_attention(q, k, k, qp, kp, causal=False,
                                        window=0))
    for causal, window in ((True, 0), (False, 4)):
        with pytest.raises(ValueError, match="non-causal"):
            t_attn.attend(q, k, k, qp, kp, causal=causal, window=window,
                          flash=True, cross=True)


def test_cross_cache_holds_the_encoder_length():
    """Prefill writes the encoder's K/V into the cross caches in place, so
    init_cache's enc_len must equal the frames' length: another raises
    ValueError naming both (the reference replaces its cache arrays,
    whatever enc_len, even the default 0 — a kept divergence)."""
    cfg, params, tcfg, tparams = ref_setup("whisper-base")
    batch = batch_for(cfg)
    r_cache = r_lm.init_cache(cfg, B, 17)  # enc_len 0: replaced at prefill
    _, r_cache = r_lm.prefill(params, cfg, as_jax(batch), r_cache)
    assert r_cache["groups"][0]["cross_k"].shape[2] == S_ENC
    for enc in (0, S_ENC - 1):
        cache = t_lm.init_cache(tcfg, B, 17, device="cpu", enc_len=enc)
        with pytest.raises(ValueError, match=f"holds {enc} encoder "
                                             f"positions, the encoder gave "
                                             f"{S_ENC}"):
            t_lm.prefill(tparams, tcfg, as_torch(batch), cache)


@pytest.mark.parametrize("sq,skv", [(5, 33), (90, 33), (33, 33), (1, 7)])
@pytest.mark.parametrize("kvh", [4, 2])
def test_kernel_plain_version_non_causal_matches_grouped_attention(sq, skv,
                                                                   kvh):
    """The kernel's plain version (what the wrapper runs on the CPU) at
    non-causal, window-0 masks with Sq < Skv (cross-attention's prefill),
    Sq > Skv (more decoder tokens than frames) and Sq = Skv (the
    encoder), against the reference's grouped_attention with the keys at
    0..Skv-1, float32."""
    rng = np.random.default_rng(sq * 100 + skv)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, kvh, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, kvh, 16)).astype(np.float32)
    qp = np.broadcast_to(np.arange(sq, dtype=np.int32), (2, sq))
    kp = np.broadcast_to(np.arange(skv, dtype=np.int32), (2, skv))
    want = r_attn.grouped_attention(*map(jnp.asarray, (q, k, v, qp, kp)),
                                    causal=False, window=0)
    got = t_fa.flash_attention(*map(torch.tensor, (q, k, v)), causal=False)
    close(got, want)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch, use_kernel):
    """The loss, per-example NLL and every gradient (whisper's encoder,
    cross-attention and learned positions; pixtral's through the blended
    patch prefix) against jax.value_and_grad of the reference's
    lm_loss."""
    cfg, params, tcfg, tparams = ref_setup(arch, seed=3)
    batch = batch_for(cfg, b=4, seed=4)
    batch["labels"][0, :5] = -1  # masked labels count nowhere
    (r_loss, r_met), r_grads = jax.value_and_grad(
        lambda p: r_lm.lm_loss(p, cfg, as_jax(batch)), has_aux=True)(params)
    loss, met, grads = t_steps.loss_and_grads(tparams, tcfg, as_torch(batch),
                                              use_kernel=use_kernel)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    for key in ("loss", "per_example_nll", "tokens"):
        np.testing.assert_allclose(met[key].numpy(), np.asarray(r_met[key]),
                                   rtol=1e-5)
    want = t_lm.from_reference_params(jax.tree.map(np.asarray, r_grads),
                                      tcfg, device="cpu")
    got = dict(leaves_with_paths(grads))
    assert dict(leaves_with_paths(want)).keys() == got.keys()
    if cfg.is_encoder_decoder:
        assert ("pos_embed",) in got and ("enc_norm", "bias") in got
        assert any(p[-2:] == ("cross", "wk") for p in got)
    grads_close(grads, want, 1e-5, "grad")


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference_whisper(micro):
    """One train_step of reduced whisper-base from the reference's state
    carried across by from_reference_train_state: loss, NLL and grad_norm
    within rtol 1e-5, first moments within 1e-5 of each leaf's largest
    magnitude; with microbatches=2 the frames are sliced with the tokens
    (the reference reshapes every leaf of the batch)."""
    cfg = r_configs.get_config("whisper-base", reduced=True)
    tcfg = t_configs.get_config("whisper-base", reduced=True)
    r_state = r_steps.init_train_state(cfg, jax.random.PRNGKey(1),
                                       reservoir_k=4)
    t_state = t_steps.from_reference_train_state(
        jax.tree.map(np.asarray, r_state), tcfg, device="cpu")
    assert t_lm.param_count(tcfg) == sum(
        x.numel() for x in t_adamw.tree_leaves(t_state.opt.m))
    batch = batch_for(cfg, b=4, seed=6)
    batch["example_ids"] = np.arange(4, dtype=np.int32)
    r_state, r_met = r_steps.train_step(r_state, as_jax(batch), cfg,
                                        lr=1e-3, microbatches=micro)
    t_state, t_met = t_steps.train_step(t_state, as_torch(batch), tcfg,
                                        lr=1e-3, microbatches=micro)
    for key in ("loss", "grad_norm", "per_example_nll", "tokens"):
        np.testing.assert_allclose(t_met[key].numpy(), np.asarray(r_met[key]),
                                   rtol=1e-5, err_msg=key)
    grads_close(t_state.opt.m, t_lm.from_reference_params(
        jax.tree.map(np.asarray, r_state.opt.m), tcfg, device="cpu"), 1e-5,
        "m")
    np.testing.assert_array_equal(t_state.reservoir.ids.numpy(),
                                  np.asarray(r_state.reservoir.ids))


def test_microbatches_slice_the_frames_with_the_tokens(monkeypatch):
    """_accumulate hands each microbatch its own rows of every key: the
    frames of rows 2-3 go with the tokens of rows 2-3."""
    tcfg = t_configs.get_config("whisper-base", reduced=True)
    params = t_lm.init_params(tcfg, seed=0, device="cpu")
    batch = as_torch(batch_for(tcfg, b=4, seed=7))
    seen = []
    real = t_steps.loss_and_grads

    def spy(p, cfg, micro, *a, **kw):
        seen.append({k: v.clone() for k, v in micro.items()})
        return real(p, cfg, micro, *a, **kw)

    monkeypatch.setattr(t_steps, "loss_and_grads", spy)
    t_steps._accumulate(params, tcfg, batch, 0.01, 2)
    assert len(seen) == 2
    for i, micro in enumerate(seen):
        assert micro.keys() == batch.keys()
        for k, v in micro.items():
            assert torch.equal(v, batch[k][2 * i:2 * i + 2]), k


def test_resume_is_bit_equal_for_whisper(tmp_path):
    """Reduced whisper-base through train_loop.run: 6 straight steps equal
    3 steps, a checkpoint and 3 resumed steps, bit for bit (under
    torch.use_deterministic_algorithms); the checkpoint's leaves hold
    the encoder, enc_norm and pos_embed, and a checkpoint restored into
    the reference's leaf order gives the same tensors."""
    cfg = t_configs.get_config("whisper-base", reduced=True)
    loader = t_pipe.StreamLoader(cfg, ShapeConfig("t", seq_len=12,
                                                  global_batch=4,
                                                  kind="train"), seed=1)
    loop = train_loop.LoopConfig(total_steps=6, ckpt_every=3, lr=1e-3)
    torch.use_deterministic_algorithms(True)
    try:
        rep_a = train_loop.run(cfg, loader, loop=loop, device="cpu")
        mgr = CheckpointManager(str(tmp_path / "b"))
        rep_b1 = train_loop.run(cfg, loader, loop=dataclasses.replace(
            loop, total_steps=3), ckpt=mgr, device="cpu")
        rep_b2 = train_loop.run(cfg, loader, loop=loop, ckpt=mgr,
                                device="cpu")
    finally:
        torch.use_deterministic_algorithms(False)
    assert rep_b1.steps_run == 3 and rep_b2.resumed_from == 3
    assert rep_a.losses[3:] == rep_b2.losses
    a = t_adamw.tree_leaves(rep_a.final_state.params)
    b = t_adamw.tree_leaves(rep_b2.final_state.params)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    params = rep_b2.final_state.params
    assert {"enc", "enc_norm", "pos_embed"} <= params.keys()
    # the port's leaf order (layer 0 of each group standing for the
    # group) is the reference's jax.tree_util order
    r_cfg = r_configs.get_config("whisper-base", reduced=True)
    r_params = r_lm.init_params(r_cfg, jax.random.PRNGKey(0))
    r_paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
               for p, _ in jax.tree_util.tree_leaves_with_path(r_params)]
    stacked = ("enc", "dec")
    t_paths = [p[:2] + p[3:] if p[0] in stacked else p
               for p in _port_order(params)
               if p[0] not in stacked or p[2] == 0]
    assert t_paths == r_paths


def _port_order(tree, path=()):
    """Leaf paths in checkpoint.manager.tree_flatten's order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _port_order(tree[k],
                                                             path + (k,))]
    if isinstance(tree, list):
        return [q for i, v in enumerate(tree)
                for q in _port_order(v, path + (i,))]
    return [path]
