"""Qwen2-VL-72B [arXiv:2409.12191; hf] — M-RoPE, dynamic resolution.

Backbone only (assignment): 80L, d_model 8192, 64 heads (kv=8), d_ff 29568,
vocab 152064. The vision frontend is a STUB: input_specs() provides
precomputed patch embeddings [b, t, d_model]; M-RoPE runs with text ids
(t==h==w), the real code path with degenerate positions.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    fsdp=True,
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, act="silu", pos="mrope", qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    num_layers=2, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=256, act="silu", pos="mrope", qkv_bias=True,
    dtype="float32", attn_chunk=32, loss_chunk=32,
)
