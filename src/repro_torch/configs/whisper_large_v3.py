"""Whisper-large-v3 [arXiv:2212.04356; unverified] — encoder-decoder.

32 decoder + 32 encoder layers, d_model 1280, 20 heads (kv=20), d_ff 5120,
vocab 51866. Conv frontend STUBBED per assignment: input_specs() provides
precomputed frame embeddings [b, t_enc, d_model]. LayerNorm, plain GELU MLP
with biases, sinusoidal positions, tied decoder embeddings.
"""
from repro_torch.models.common import EncDecCfg, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866, act="gelu", pos="sinusoid",
    norm="layernorm", mlp_glu=False, qkv_bias=True, proj_bias=True,
    tie_embeddings=True,
    encdec=EncDecCfg(enc_layers=32, dec_ratio=8),
)

SMOKE = ModelConfig(
    name="whisper-large-v3-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, act="gelu", pos="sinusoid",
    norm="layernorm", mlp_glu=False, qkv_bias=True, proj_bias=True,
    tie_embeddings=True,
    encdec=EncDecCfg(enc_layers=2, dec_ratio=8),
    dtype="float32", attn_chunk=32, loss_chunk=32,
)
