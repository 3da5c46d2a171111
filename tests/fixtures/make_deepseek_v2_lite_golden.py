"""Write ``deepseek_v2_lite_golden.npz`` (float32) or
``deepseek_v2_lite_golden_bf16.npz`` (bfloat16): the reference LM's logits
and MoE routing for deepseek-v2-lite-16b at full width and depth 2, the
goldens that ``chip_smoke.py`` holds the port against on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_deepseek_v2_lite_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_deepseek_v2_lite_golden.py --dtype bfloat16

The reference package (``repro.models.lm``) runs deepseek-v2-lite-16b's full
config (d_model 2048, 16 heads, MLA with kv_lora_rank 512 and rope / nope /
v 64 / 128 / 128, 64 routed experts top-6 + 2 shared at d_ff_expert 1408,
vocab 102400) cut to 2 layers (layer 0 dense at d_ff 10944, layer 1 MoE:
~1.09 B parameters) with the weights of
``repro_torch.convert.numpy_lm_leaves(cfg, seed=0)``: a prefill of a batch
of 2 prompts of 64 tokens (capacity 8 a group and expert), then 3 decode
steps, teacher-forced with fixed tokens. For each of the 4 steps the file
keeps the top-40 logits of each row (indices and values; the comparison
takes the top 32), the logsumexp over the vocabulary and the RMS over its
real entries. For the MoE layer's prefill it keeps the routing: each
token's top-6 experts (``route_idx``), their router probabilities and the
7th (``route_prob``, to tell a near-tie from an error), the keep mask of
the capacity cut (``route_keep``, token-major as the reference's
assignments) and, per group and expert, the gap between the criticality keys
on either side of the cut (``route_cut_gap``, inf where the expert took no
more than its capacity); the same for each decode step (``step_route_*``,
a single token a group: nothing drops; the committed float32 golden was
written before the maker kept them). The routing is the reference's own
arithmetic (``repro/models/moe.py`` lines 76-100) on the MoE input that the reference's
prefill computed, read out of it with ``jax.debug.callback``; its dropped
count must equal the ``moe_dropped`` of the reference's ``forward`` on the
same prompt. Also each weight leaf's path, shape, dtype and float64 sum, so
that a test can check that the recipe still makes these weights. The
leaves, the bfloat16 rounding and the layout are those of
``make_mamba2_130m_golden.py`` (whose :func:`make` this runs). Takes ~26 s
and 5.3 GiB at its peak on the CPU in float32, ~40 s and 5.8 GiB in
bfloat16.
"""
from __future__ import annotations

import sys

from make_mamba2_130m_golden import cli

if __name__ == "__main__":
    sys.exit(cli("deepseek-v2-lite-16b", 2, "deepseek_v2_lite", prompt=64,
                 routing_segment=1))
