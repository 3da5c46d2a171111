"""Write ``dbrx_132b_golden.npz`` (float32) or ``dbrx_132b_golden_bf16.npz``
(bfloat16): the reference LM's logits and MoE routing for dbrx-132b at full
width cut to 1 layer, the goldens that ``chip_smoke.py`` holds the port
against on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_dbrx_132b_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_dbrx_132b_golden.py --dtype bfloat16

dbrx-132b's full config (d_model 6144, 48 query heads over 8 kv heads of
128, RoPE at theta 500,000, 16 experts top-4 at d_ff_expert 10752 with
capacity factor 1.25, vocab 100,352, an untied head) cut to its first of 40
layers (~4.49 B parameters: the embedding and the head 1.23 B, the layer's
16 experts 3.17 B). Depth 1 because one more layer adds ~3.3 B values.
Otherwise as ``make_deepseek_v2_lite_golden.py``: the recipe's weights from
seed 0, a batch of 2 prompts of 300 tokens (capacity 94 a group and
expert) and 3 teacher-forced decode steps, the top-40 logits, logsumexp and
RMS of each step, the MoE layer's routing of the prefill (``route_idx``,
``route_prob``, ``route_keep``, ``route_cut_gap``, ``moe_dropped``) and of
each decode step (``step_route_*``) and each
weight leaf's path, shape, dtype and float64 sum. Takes ~115 s and 21.0
GiB at its peak on the CPU in float32, ~143 s and 23.8 GiB in bfloat16.
"""
from __future__ import annotations

import sys

from make_mamba2_130m_golden import cli

if __name__ == "__main__":
    sys.exit(cli("dbrx-132b", 1, "dbrx_132b", routing_segment=0))
