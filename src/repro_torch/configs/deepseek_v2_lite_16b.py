"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434; hf] — MLA (kv_lora=512) + MoE.

27L, d_model 2048, 16 heads, vocab 102400. MoE: 64 routed experts top-6 +
2 shared, expert d_ff 1408; layer 0 is a dense FFN (d_ff 10944).
NOTE: the assignment sheet says "2 shared+160 routed top-6" next to "MoE 64e
top-6"; 64 routed matches both the "64e" field and the HF release, so we use
64 routed (+2 shared) and record the discrepancy here.
"""
from repro_torch.models.common import MLACfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    fsdp=True,
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400, act="silu", pos="rope",
    mla=MLACfg(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoECfg(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2,
               first_dense_layers=1),
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=160, vocab_size=256, act="silu", pos="rope",
    mla=MLACfg(kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16, v_head_dim=16),
    moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=64, num_shared=1,
               first_dense_layers=1),
    dtype="float32", attn_chunk=32, loss_chunk=32,
)
