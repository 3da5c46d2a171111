"""MiniCPM-2B [arXiv:2404.06395; hf] — dense llama-like, trained with WSD.

40L, d_model 2304, 36 heads (GQA kv=36 == MHA), d_ff 5760, vocab 122753.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753, act="silu", pos="rope",
    tie_embeddings=True,  # MiniCPM ties embeddings
)

SMOKE = ModelConfig(
    name="minicpm-2b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=160, vocab_size=256, act="silu", pos="rope",
    tie_embeddings=True, dtype="float32", attn_chunk=32, loss_chunk=32,
)
