"""Mamba2-130M [arXiv:2405.21060; unverified] — SSD, attention-free.

24L, d_model 768, ssm_state 128, vocab 50280. head_dim 64, expand 2.
"""
from repro_torch.models.common import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, pos="none",
    ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=256, pos="none",
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
    tie_embeddings=True, dtype="float32", attn_chunk=32, loss_chunk=32,
)
