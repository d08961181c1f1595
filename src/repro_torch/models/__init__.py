# The LM that produces the serving path's scores and trains with top-K
# curation: decoder-only attention models with dense FFNs (the reference's
# models, GQA and dense parts).
from . import attention, blocks, common, ffn, lm  # noqa: F401
from .lm import (abstract_params, decode_step, forward, init_cache,  # noqa: F401
                 init_params, lm_loss, param_count, prefill)
