# The LM that produces the serving path's scores and trains with top-K
# curation: the reference's model zoo (attention, SSD, hybrid and MoE
# decoders, the vision-patch frontend and the encoder-decoder).
from . import attention, blocks, common, ffn, lm  # noqa: F401
from .lm import (abstract_params, decode_step, encode, forward,  # noqa: F401
                 init_cache, init_params, lm_loss, param_count, prefill)
