"""Abstract input specs for the dry run — the port of the reference's
``launch.specs``: every model input and state as tensors on the ``meta``
device (shapes and dtypes, no storage), where the reference builds
``ShapeDtypeStruct`` stand-ins."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.runtime import steps


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Training / prefill batch (tokens+labels / tokens)."""
    b = shape.global_batch
    s = shape.seq_len
    dec_len = cfg.decoder_len if cfg.is_encoder_decoder else s
    out = {"tokens": sds((b, dec_len), torch.int32)}
    if shape.is_train:
        out["labels"] = sds((b, dec_len), torch.int32)
        out["example_ids"] = sds((b,), torch.int32)
    if cfg.is_encoder_decoder:
        out["frames"] = sds((b, s, cfg.d_model), torch.float32)
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = sds((b, cfg.n_patches, cfg.d_model),
                                  torch.float32)
    return out


def cache_len(cfg: ModelConfig, total: int) -> int:
    w = cfg.max_window
    return min(w, total) if w > 0 else total


def cache_spec(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The caches of a prefill or decode cell on ``meta``: a
    seq_len-deep cache (an encoder-decoder's decoder_len + 1 deep, with
    the encoder's seq_len frames)."""
    if cfg.is_encoder_decoder:
        kv = cache_len(cfg, cfg.decoder_len + 1)
        enc_len = shape.seq_len
    else:
        kv = cache_len(cfg, shape.seq_len)
        enc_len = 0
    return lm.init_cache(cfg, shape.global_batch, kv, device="meta",
                         enc_len=enc_len)


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig):
    """(token_spec, cache_spec) for a serve_step with a seq_len-deep cache."""
    return sds((shape.global_batch,), torch.int32), cache_spec(cfg, shape)


def train_state_spec(cfg: ModelConfig, reservoir_k: int = 1024):
    return steps.abstract_train_state(cfg, reservoir_k)
