"""The LM stack: config schema, attention, MLA, the MoE FFN, blocks and the
language model."""
from . import attention, blocks, common, lm, mla, moe

__all__ = ["attention", "blocks", "common", "lm", "mla", "moe"]
