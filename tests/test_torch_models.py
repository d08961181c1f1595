"""The port's configs and LM against the reference's, at reduced size with
the reference's weights carried across by ``from_reference_params``:
``get_config`` field by field for all ten architectures, parameter
counts and shapes, ``forward``, and ``prefill`` then ``decode_step``
against ``repro.models.lm``; prefill-then-decode against the port's own
forward (as tests/test_decode.py holds the reference); yi-9b's and
command-r-plus-104b's attention geometry (head dim 128, query groups of
8 and 12, RoPE theta 5e6 and 75e6) over a prefill of 1024 positions at
a narrow width, and their full parameter counts. The
encoder-decoder and vision-frontend paths, whose batches carry frame or
patch embeddings, are held in tests/test_torch_encdec.py.

Tolerance: float32 logits within 2e-5 absolute and relative of the
reference's (matrix products and softmax sums in another order on
another backend), the same for the port's kernel route (flash attention's
plain version) against its plain route; prefill/decode against forward
as the reference's own test (2e-3 relative, 3e-4 absolute).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import lm as r_lm
from repro_torch import configs as t_configs
from repro_torch.models import common as t_common
from repro_torch.models import lm as t_lm

TOL = dict(rtol=2e-5, atol=2e-5)
PORTED = ["llama3.2-1b", "yi-9b", "starcoder2-3b", "command-r-plus-104b",
          "mamba2-2.7b", "hymba-1.5b", "grok-1-314b", "deepseek-v2-236b",
          "whisper-base", "pixtral-12b"]


def ref_setup(arch, seed=0):
    cfg = r_configs.get_config(arch, reduced=True)
    params = r_lm.init_params(cfg, jax.random.PRNGKey(seed))
    params_np = jax.tree.map(np.asarray, params)
    tcfg = t_configs.get_config(arch, reduced=True)
    return cfg, params, tcfg, t_lm.from_reference_params(params_np, tcfg,
                                                         device="cpu")


def tokens_for(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


@pytest.mark.parametrize("reduced", [False, True])
def test_get_config_equals_reference_for_every_arch(reduced):
    assert t_configs.list_archs() == r_configs.list_archs()
    for arch in r_configs.list_archs():
        t = t_configs.get_config(arch, reduced=reduced)
        r = r_configs.get_config(arch, reduced=reduced)
        assert dataclasses.asdict(t) == dataclasses.asdict(r), arch
        assert (t.n_layers, t.max_window, t.attention_free) == \
            (r.n_layers, r.max_window, r.attention_free)
    assert {k: dataclasses.asdict(v) for k, v in t_configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in r_configs.SHAPES.items()}
    with pytest.raises(KeyError):
        t_configs.get_config("nope")


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_and_shapes_equal_reference(arch):
    for reduced in (True, False):
        cfg = r_configs.get_config(arch, reduced=reduced)
        assert t_lm.param_count(t_configs.get_config(arch, reduced=reduced)) \
            == r_lm.param_count(cfg)
    _, params, tcfg, tparams = ref_setup(arch)
    ours = t_lm.init_params(tcfg, seed=0, device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in ref_leaves:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] in ("dec", "enc"):  # stacked over the layer axis
            for i in range(leaf.shape[0]):
                node_t, node_o = tparams[keys[0]][keys[1]][i], \
                    ours[keys[0]][keys[1]][i]
                for k in keys[2:]:
                    node_t, node_o = node_t[k], node_o[k]
                np.testing.assert_array_equal(node_t.numpy(),
                                              np.asarray(leaf[i]))
                assert tuple(node_o.shape) == leaf.shape[1:]
        else:
            node_t, node_o = tparams, ours
            for k in keys:
                node_t, node_o = node_t[k], node_o[k]
            np.testing.assert_array_equal(node_t.numpy(), np.asarray(leaf))
            assert tuple(node_o.shape) == leaf.shape


def test_init_dense_is_a_truncated_fan_in_normal():
    gen = torch.Generator().manual_seed(0)
    w = t_common.init_dense(gen, (512, 4, 64), (0,))
    std = 1 / np.sqrt(512)
    assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
    # a standard normal truncated to ±2 has std 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01
    p = t_lm.init_params(t_configs.get_config("llama3.2-1b", reduced=True),
                         seed=5, device="cpu")
    q = t_lm.init_params(t_configs.get_config("llama3.2-1b", reduced=True),
                         seed=5, device="cpu")
    torch.testing.assert_close(p["embed"], q["embed"])
    assert not bool(p["final_norm"]["scale"].any())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "yi-9b", "starcoder2-3b",
                                  "command-r-plus-104b", "mamba2-2.7b",
                                  "hymba-1.5b", "grok-1-314b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_forward_matches_reference(arch, use_kernel):
    """Logits and the aux loss (the MoE layers' load-balancing loss,
    exactly 0 without MoE)."""
    cfg, params, tcfg, tparams = ref_setup(arch)
    toks = tokens_for(cfg, 2, 24)
    ref, r_aux = r_lm.forward(params, cfg, {"tokens": jnp.asarray(toks)})
    got, aux = t_lm.forward(tparams, tcfg, {"tokens": torch.tensor(toks)},
                            use_kernel=use_kernel)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    close(got, ref)
    close(aux, r_aux)
    assert (float(aux) == 0.0) == (cfg.n_experts == 0)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "yi-9b", "starcoder2-3b",
                                  "command-r-plus-104b", "mamba2-2.7b",
                                  "hymba-1.5b", "grok-1-314b",
                                  "deepseek-v2-236b"])
def test_prefill_and_decode_match_reference(arch):
    """Logits of the prefill and of each decode step, then every layer's
    cache against the reference's: the KV cache's positions exactly (a
    rolling window of 8 in starcoder2's layers and hymba's second group,
    which the 12-token prompt overruns) and its K/V, the SSM state and
    the conv state within TOL; deepseek's MLA latent cache (positions
    exactly, latents and RoPE keys within TOL)."""
    cfg, params, tcfg, tparams = ref_setup(arch)
    toks = tokens_for(cfg, 2, 20)
    t0, kv_len = 12, 21
    r_cache = r_lm.init_cache(cfg, 2, kv_len)
    r_logits, r_cache = r_lm.prefill(params, cfg,
                                     {"tokens": jnp.asarray(toks[:, :t0])},
                                     r_cache)
    t_cache = t_lm.init_cache(tcfg, 2, kv_len, device="cpu")
    t_logits, t_cache = t_lm.prefill(tparams, tcfg,
                                     {"tokens": torch.tensor(toks[:, :t0])},
                                     t_cache)
    close(t_logits, r_logits)
    assert t_cache["pos"] == int(r_cache["pos"]) == t0
    for t in range(t0, 20):
        r_logits, r_cache = r_lm.decode_step(params, cfg,
                                             jnp.asarray(toks[:, t]), r_cache)
        t_logits, t_cache = t_lm.decode_step(tparams, tcfg,
                                             torch.tensor(toks[:, t]),
                                             t_cache)
        close(t_logits, r_logits)
    assert t_cache["pos"] == int(r_cache["pos"]) == 20
    kinds = set()
    for t_group, r_group in zip(t_cache["groups"], r_cache["groups"]):
        assert len(t_group) == len(jax.tree.leaves(r_group)[0])
        for li, lc in enumerate(t_group):
            assert lc.keys() == r_group.keys()
            kinds.update(lc)
            if "kv" in lc:
                r_kv = r_group["kv"]
                np.testing.assert_array_equal(lc["kv"].pos.numpy(),
                                              np.asarray(r_kv.pos[li]))
                close(lc["kv"].k, r_kv.k[li])
                close(lc["kv"].v, r_kv.v[li])
            if "ssm" in lc:
                r_st = r_group["ssm"]
                assert lc["ssm"].state.dtype == torch.float32
                close(lc["ssm"].state, r_st.state[li])
                close(lc["ssm"].conv, r_st.conv[li])
            if "mla" in lc:
                r_mla = r_group["mla"]
                np.testing.assert_array_equal(lc["mla"].pos.numpy(),
                                              np.asarray(r_mla.pos[li]))
                close(lc["mla"].ckv, r_mla.ckv[li])
                close(lc["mla"].krope, r_mla.krope[li])
    assert kinds == {"mamba2-2.7b": {"ssm"}, "hymba-1.5b": {"kv", "ssm"},
                     "deepseek-v2-236b": {"mla"}}.get(arch, {"kv"})


@pytest.mark.parametrize("arch", ["llama3.2-1b", "yi-9b", "starcoder2-3b",
                                  "command-r-plus-104b", "mamba2-2.7b",
                                  "hymba-1.5b", "grok-1-314b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_prefill_then_decode_matches_forward(arch, use_kernel):
    tcfg = t_configs.get_config(arch, reduced=True)
    params = t_lm.init_params(tcfg, seed=1, device="cpu")
    toks = torch.tensor(tokens_for(tcfg, 2, 20))
    full, _ = t_lm.forward(params, tcfg, {"tokens": toks},
                           use_kernel=use_kernel)
    t0 = 10
    w = tcfg.max_window
    cache = t_lm.init_cache(tcfg, 2, min(w, 21) if w else 21, device="cpu")
    logits, cache = t_lm.prefill(params, tcfg, {"tokens": toks[:, :t0]},
                                 cache, use_kernel=use_kernel)
    close(logits, full[:, t0 - 1], rtol=2e-3, atol=2e-4)
    for t in range(t0, 20):
        logits, cache = t_lm.decode_step(params, tcfg, toks[:, t], cache)
        close(logits, full[:, t], rtol=2e-3, atol=3e-4)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_attention_softcap_forward_matches_reference(use_kernel):
    """Reduced llama3.2-1b with its attention logits soft-capped at 30 (no
    head cap): logits against the reference's forward, through the
    kernel's plain version and the grouped attention; the cap moves
    them."""
    cfg = r_configs.get_config("llama3.2-1b", reduced=True).replace(
        attn_logit_softcap=30.0)
    tcfg = t_configs.get_config("llama3.2-1b", reduced=True).replace(
        attn_logit_softcap=30.0)
    params = r_lm.init_params(cfg, jax.random.PRNGKey(2))
    tparams = t_lm.from_reference_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    # larger query weights, so that the cap bites
    for lp in tparams["dec"][0]:
        lp["attn"]["wq"] = lp["attn"]["wq"] * 8.0
    params["dec"][0]["attn"]["wq"] = params["dec"][0]["attn"]["wq"] * 8.0
    toks = tokens_for(cfg, 2, 24)
    ref, _ = r_lm.forward(params, cfg, {"tokens": jnp.asarray(toks)})
    got, _ = t_lm.forward(tparams, tcfg, {"tokens": torch.tensor(toks)},
                          use_kernel=use_kernel)
    close(got, ref)
    plain, _ = t_lm.forward(tparams, tcfg.replace(attn_logit_softcap=0.0),
                            {"tokens": torch.tensor(toks)},
                            use_kernel=use_kernel)
    assert float((plain - got).abs().max()) > 1e-4


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_configs.get_config("llama3.2-1b", reduced=True)
    for call in (lambda: t_lm.init_params(cfg),
                 lambda: t_lm.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b", "hymba-1.5b",
                                  "grok-1-314b", "deepseek-v2-236b"])
def test_abstract_params_dtypes_equal_reference(arch):
    """Leaf by leaf, shapes and dtypes of ``abstract_params`` against the
    reference's ``jax.eval_shape`` at bfloat16 parameters: the SSM's
    a_log, dt_bias and d_skip and the MoE's router stay float32."""
    cfg = r_configs.get_config(arch, reduced=True).with_dtypes("bfloat16",
                                                               "bfloat16")
    tcfg = t_configs.get_config(arch, reduced=True).with_dtypes("bfloat16",
                                                                "bfloat16")
    ours = t_lm.abstract_params(tcfg)
    seen = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            r_lm.abstract_params(cfg)):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        node = ours
        for k in keys[:2] if keys[0] == "dec" else keys:
            node = node[k]
        if keys[0] == "dec":
            node = node[0]
            for k in keys[2:]:
                node = node[k]
            want = leaf.shape[1:]
        else:
            want = leaf.shape
        assert node.device.type == "meta"
        assert (tuple(node.shape), str(node.dtype)[6:]) == \
            (want, str(leaf.dtype)), keys
        seen.add(str(leaf.dtype))
    assert seen == ({"bfloat16"} if arch == "llama3.2-1b"
                    else {"bfloat16", "float32"})


def test_none_mixer_matches_reference():
    """Layers with the ``none`` mixer (zeros; the FFN alone) beside
    attention layers: parameter count and forward logits against the
    reference's."""
    from repro.configs.base import LayerSpec as RSpec
    from repro_torch.configs.base import LayerSpec as TSpec
    cfg = r_configs.get_config("llama3.2-1b", reduced=True)
    cfg = cfg.replace(layers=(RSpec(count=1), RSpec(count=2, mixer="none")))
    tcfg = t_configs.get_config("llama3.2-1b", reduced=True)
    tcfg = tcfg.replace(layers=(TSpec(count=1), TSpec(count=2,
                                                      mixer="none")))
    assert t_lm.param_count(tcfg) == r_lm.param_count(cfg)
    params = r_lm.init_params(cfg, jax.random.PRNGKey(4))
    tparams = t_lm.from_reference_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    assert tparams["dec"][1][0].keys() == {"ffn", "norm_ffn"}
    toks = tokens_for(cfg, 2, 12)
    ref, _ = r_lm.forward(params, cfg, {"tokens": jnp.asarray(toks)})
    got, _ = t_lm.forward(tparams, tcfg, {"tokens": torch.tensor(toks)})
    close(got, ref)


def test_deepseek_full_size_param_count():
    """The whole deepseek-v2-236b: 235,741,434,880 parameters, as the
    reference counts them; and the 3-of-60-layer cut the card serves (the
    dense layer 0 and two MoE layers): 9,330,795,520."""
    from repro_torch.configs.base import LayerSpec
    cfg = t_configs.get_config("deepseek-v2-236b")
    assert t_lm.param_count(cfg) == 235_741_434_880 == r_lm.param_count(
        r_configs.get_config("deepseek-v2-236b"))
    cut = cfg.replace(layers=(LayerSpec(count=1, mixer="attn", ffn="dense"),
                              LayerSpec(count=2, mixer="attn", ffn="moe")))
    assert t_lm.param_count(cut) == 9_330_795_520
    shapes = t_lm.param_shapes(cfg)["dec"][1][0]["attn"]
    assert shapes["wkv_b"] == (512, 128, 256) and shapes["wq_b"] == (
        1536, 128, 192)


def test_yi_and_command_r_full_size_param_counts():
    """yi-9b (8,829,407,232 parameters, served whole on the card) and
    command-r-plus-104b (103,810,609,152) as the reference counts them;
    and the 2-of-64-layer cut the card serves: 6,291,517,440, the tied
    embedding's 3,145,728,000 among them."""
    from repro_torch.configs.base import LayerSpec
    counts = {"yi-9b": 8_829_407_232, "command-r-plus-104b": 103_810_609_152}
    for arch, n in counts.items():
        assert t_lm.param_count(t_configs.get_config(arch)) == n == \
            r_lm.param_count(r_configs.get_config(arch))
    cfg = t_configs.get_config("command-r-plus-104b")
    cut = cfg.replace(layers=(LayerSpec(count=2, mixer="attn", ffn="dense"),))
    assert cfg.tie_embeddings and "lm_head" not in t_lm.param_shapes(cut)
    assert t_lm.param_count(cut) == 6_291_517_440
    assert t_lm.param_shapes(cut)["embed"] == (256_000, 12_288)


# (arch, query heads, KV heads): the full configs' head dim of 128 and
# query group (yi-9b 32 over 4: 8; command-r-plus-104b 96 over 8: 12) at
# a narrow width, two KV heads
GEOMETRY = [("yi-9b", 16, 2), ("command-r-plus-104b", 24, 2)]
GEOMETRY_PROMPT, GEOMETRY_STEPS = 1024, 6


@pytest.mark.parametrize("arch,heads,kv_heads", GEOMETRY)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_full_attention_geometry_matches_reference(arch, heads, kv_heads,
                                                   use_kernel):
    """Each config narrowed in width (2 layers, d_model 128, d_ff 256,
    vocab 512) but kept at head dim 128, its query group and its own RoPE
    theta (5e6, 75e6) and tied or untied head: a prefill of 1024
    positions, then decode steps past it, the logits of each against
    ``repro.models.lm``'s within TOL, and the rotary embedding at those
    theta and positions against the reference's ``apply_rope``."""
    from repro.configs.base import LayerSpec as RSpec
    from repro.models import common as r_common
    from repro_torch.configs.base import LayerSpec as TSpec
    narrow = dict(d_model=128, d_ff=256, vocab_size=512, n_heads=heads,
                  n_kv_heads=kv_heads)
    cfg = r_configs.get_config(arch).replace(
        layers=(RSpec(count=2, mixer="attn", ffn="dense"),), **narrow)
    tcfg = t_configs.get_config(arch).replace(
        layers=(TSpec(count=2, mixer="attn", ffn="dense"),), **narrow)
    assert (tcfg.head_dim, tcfg.rope_theta) == (128, {
        "yi-9b": 5e6, "command-r-plus-104b": 75e6}[arch])
    params = r_lm.init_params(cfg, jax.random.PRNGKey(6))
    tparams = t_lm.from_reference_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    total = GEOMETRY_PROMPT + GEOMETRY_STEPS
    toks = tokens_for(cfg, 2, total, seed=7)
    r_cache = r_lm.init_cache(cfg, 2, total + 1)
    r_logits, r_cache = r_lm.prefill(
        params, cfg, {"tokens": jnp.asarray(toks[:, :GEOMETRY_PROMPT])},
        r_cache)
    t_cache = t_lm.init_cache(tcfg, 2, total + 1, device="cpu")
    t_logits, t_cache = t_lm.prefill(
        tparams, tcfg, {"tokens": torch.tensor(toks[:, :GEOMETRY_PROMPT])},
        t_cache, use_kernel=use_kernel)
    close(t_logits, r_logits)
    for t in range(GEOMETRY_PROMPT, total):
        r_logits, r_cache = r_lm.decode_step(params, cfg,
                                             jnp.asarray(toks[:, t]), r_cache)
        t_logits, t_cache = t_lm.decode_step(tparams, tcfg,
                                             torch.tensor(toks[:, t]),
                                             t_cache)
        close(t_logits, r_logits)
    x = np.random.default_rng(8).standard_normal(
        (2, total, heads, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(total, dtype=np.int32), (2, total))
    close(t_common.apply_rope(torch.tensor(x), torch.tensor(pos),
                              tcfg.rope_theta),
          r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                              cfg.rope_theta))
