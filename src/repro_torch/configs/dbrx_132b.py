"""DBRX-132B [hf:databricks/dbrx-base; unverified] — fine-grained MoE,
16 experts top-4. 40L, d_model 6144, 48 heads (kv=8), expert d_ff 10752,
vocab 100352. Total ~132B params, ~36B active.
"""
from repro_torch.models.common import ModelConfig, MoECfg

CONFIG = ModelConfig(
    fsdp=True,
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352, act="silu", pos="rope",
    rope_theta=500_000.0,
    moe=MoECfg(num_experts=16, top_k=4, d_ff_expert=10752),
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, act="silu", pos="rope",
    moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=128),
    dtype="float32", attn_chunk=32, loss_chunk=32,
)
