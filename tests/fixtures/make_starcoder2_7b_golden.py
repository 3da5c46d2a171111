"""Write ``starcoder2_7b_golden.npz`` (float32) or
``starcoder2_7b_golden_bf16.npz`` (bfloat16): the reference LM's logits for
starcoder2-7b at full width cut to 2 layers, the goldens that
``chip_smoke.py`` holds the port against on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_starcoder2_7b_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_starcoder2_7b_golden.py --dtype bfloat16

starcoder2-7b's full config (d_model 4608, 36 query heads over 4 kv heads
of 128: groups of 9 rows; LayerNorm with biases, biases on q, k, v and the
out-projection, a plain GELU MLP (``mlp_glu=False``) at d_ff 18432 with
biases, vocab 49,152, an untied head) cut to its first 2 of 32 layers
(~887 M parameters). Otherwise as ``make_mamba2_130m_golden.py`` (whose
:func:`make` this runs): the recipe's weights from seed 0 (its
biases zero and its norm weights one, as the reference's initialisers
make them), a batch of 2 prompts of 300 tokens and 3 teacher-forced decode
steps, the top-40 logits, logsumexp and RMS of each step and each weight
leaf's path, shape and float64 sum. Takes ~21 s and 4.6 GiB at its peak
on the CPU in float32, ~24 s and 5.5 GiB in bfloat16.
"""
from __future__ import annotations

import sys

from make_mamba2_130m_golden import cli

if __name__ == "__main__":
    sys.exit(cli("starcoder2-7b", 2, "starcoder2_7b"))
