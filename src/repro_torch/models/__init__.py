"""The LM stack: config schema, attention, MLA, the MoE FFN, Mamba2 (SSD),
blocks and the language model."""
from . import attention, blocks, common, lm, mla, moe, ssm

__all__ = ["attention", "blocks", "common", "lm", "mla", "moe", "ssm"]
