"""StarCoder2-7B [arXiv:2402.19173; hf] — GQA (kv=4), RoPE, plain GELU MLP
with biases. 32L, d_model 4608, 36 heads, d_ff 18432, vocab 49152.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    fsdp=True,
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152, act="gelu", pos="rope",
    mlp_glu=False, qkv_bias=True, proj_bias=True, norm="layernorm",
)

SMOKE = ModelConfig(
    name="starcoder2-7b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, act="gelu", pos="rope",
    mlp_glu=False, qkv_bias=True, proj_bias=True, norm="layernorm",
    dtype="float32", attn_chunk=32, loss_chunk=32,
)
