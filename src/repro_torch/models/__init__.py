# The LM that produces the serving path's scores: decoder-only attention
# models with dense FFNs (the reference's models, GQA and dense parts).
from . import attention, blocks, common, ffn, lm  # noqa: F401
