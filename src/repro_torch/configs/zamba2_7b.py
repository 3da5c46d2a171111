"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 + shared attention.

81L, d_model 3584, 32 heads (kv=32, head_dim 112), d_ff 14336, ssm_state 64,
vocab 32000. Interpretation (recorded per DESIGN.md): every 7th layer is an
application of ONE shared attention+FFN block (11 applications, distinct KV
caches); the remaining 70 layers are Mamba2 (expand 2, head_dim 64). The
real model's per-application LoRA deltas and embedding-concat input are
omitted (noted in DESIGN.md §Arch-applicability).
"""
from repro_torch.models.common import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    fsdp=True,
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, act="silu", pos="rope",
    ssm=SSMCfg(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    attn_every=7,
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke", family="hybrid",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, act="silu", pos="rope",
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
    attn_every=3, dtype="float32", attn_chunk=32, loss_chunk=32,
)
