"""Gemma-2B [arXiv:2403.08295; hf] — GeGLU, head_dim=256, MQA (kv=1).

18L, d_model 2048, 8 heads (kv=1), d_ff 16384, vocab 256000.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, act="gelu", pos="rope",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-2b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=32,
    d_ff=128, vocab_size=256, act="gelu", pos="rope",
    tie_embeddings=True, dtype="float32", attn_chunk=32, loss_chunk=32,
)
