"""Qwen2-0.5B [arXiv:2407.10671; hf] — GQA (kv=2), QKV bias, tied embeddings.

24L, d_model 896, 14 heads (kv=2), d_ff 4864, vocab 151936.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936, act="silu", pos="rope", qkv_bias=True,
    tie_embeddings=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=256, act="silu", pos="rope", qkv_bias=True,
    tie_embeddings=True, dtype="float32", attn_chunk=32, loss_chunk=32,
)
