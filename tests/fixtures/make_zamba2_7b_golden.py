"""Write ``zamba2_7b_golden.npz`` (float32) or ``zamba2_7b_golden_bf16.npz``
(bfloat16): the reference LM's logits for zamba2-7b at full width cut to 7
layers, the goldens that ``chip_smoke.py`` holds the port against on the
card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_zamba2_7b_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_zamba2_7b_golden.py --dtype bfloat16

zamba2-7b's full config (d_model 3584; Mamba2 layers with d_inner 7168, 112
SSM heads of 64, d_state 64, chunk 256; one shared attention + FFN block of
32 heads of 112 and d_ff 14336, applied at every 7th layer; vocab 32000,
untied head) cut to its first 7 layers: 6 Mamba2 layers and one
application of the shared block (~903 M parameters). Otherwise as
``make_mamba2_130m_golden.py`` (whose :func:`make` this runs): the
recipe's weights from seed 0, a batch of 2 prompts of 300 tokens and 3
teacher-forced decode steps, the top-40 logits, logsumexp and RMS of each
step and each weight leaf's path, shape and float64 sum. Takes ~24 s and
4.4 GiB at its peak on the CPU in float32, ~26 s and 5.6 GiB in bfloat16.
"""
from __future__ import annotations

import sys

from make_mamba2_130m_golden import cli

if __name__ == "__main__":
    sys.exit(cli("zamba2-7b", 7, "zamba2_7b"))
