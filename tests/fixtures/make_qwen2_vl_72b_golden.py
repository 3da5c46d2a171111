"""Write ``qwen2_vl_72b_golden.npz`` (float32) or
``qwen2_vl_72b_golden_bf16.npz`` (bfloat16): the reference LM's logits for
qwen2-vl-72b at full width cut to 2 layers, the goldens that
``chip_smoke.py`` holds the port against on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_qwen2_vl_72b_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_qwen2_vl_72b_golden.py --dtype bfloat16

qwen2-vl-72b's full config (d_model 8192, 64 query heads over 8 kv heads of
128, biases on q, k and v, M-RoPE, SwiGLU at d_ff 29568, vocab 152,064, an
untied head) cut to its first 2 of 80 layers (~4.25 B parameters, 2.49 B of
them the embedding and the head). The prompt is tokens, so M-RoPE runs on
the text positions the reference's ``prefill`` and ``decode_step`` give
them (``make_positions``: the temporal, height and width ids all equal to
the token's position). Otherwise as ``make_mamba2_130m_golden.py`` (whose
:func:`make` this runs): the recipe's weights from seed 0, a batch of 2
prompts of 300 tokens and 3 teacher-forced decode steps, the top-40
logits, logsumexp and RMS of each step and each weight leaf's path, shape,
dtype and float64 sum. Takes ~102 s and 24.3 GiB at its peak on the CPU in
float32, ~117 s and 25.3 GiB in bfloat16.
"""
from __future__ import annotations

import sys

from make_mamba2_130m_golden import cli

if __name__ == "__main__":
    sys.exit(cli("qwen2-vl-72b", 2, "qwen2_vl_72b"))
