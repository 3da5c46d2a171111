"""Write ``gemma_2b_golden.npz`` (float32) or ``gemma_2b_golden_bf16.npz``
(bfloat16): the reference LM's logits for gemma-2b at full width cut to 4
layers, the goldens that ``chip_smoke.py`` holds the port against on the
card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_gemma_2b_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_gemma_2b_golden.py --dtype bfloat16

gemma-2b's full config (d_model 2048, 8 query heads over one kv head of
256 (MQA), GeGLU at d_ff 16384 with the tanh GELU of ``jax.nn.gelu``, vocab
256,000 with the head tied to the embedding) cut to its first 4 of 18
layers (~965 M parameters). Otherwise as ``make_mamba2_130m_golden.py``
(whose :func:`make` this runs): the recipe's weights from seed 0,
a batch of 2 prompts of 300 tokens (not a multiple of the port's 64-key
tiles) and 3 teacher-forced decode steps, the top-40 logits, logsumexp
and RMS of each step and each weight leaf's path, shape and float64 sum.
Takes ~23 s and 4.9 GiB at its peak on the CPU in float32, ~24 s and 6.3
GiB in bfloat16.
"""
from __future__ import annotations

import sys

from make_mamba2_130m_golden import cli

if __name__ == "__main__":
    sys.exit(cli("gemma-2b", 4, "gemma_2b"))
