"""Write ``minicpm_2b_golden.npz`` (float32) or ``minicpm_2b_golden_bf16.npz``
(bfloat16): the reference LM's logits for minicpm-2b at full width cut to
8 layers, the goldens that ``chip_smoke.py`` holds the port against on the
card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_minicpm_2b_golden.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_minicpm_2b_golden.py --dtype bfloat16

minicpm-2b's full config (d_model 2304, 36 heads over 36 kv heads of 64
(MHA), SwiGLU at d_ff 5760, vocab 122,753 padded to 122,880 with the head
tied to the embedding) cut to its first 8 of 40 layers (~772 M
parameters). Otherwise as ``make_mamba2_130m_golden.py`` (whose
:func:`make` this runs): the recipe's weights from seed 0, a batch
of 2 prompts of 300 tokens and 3 teacher-forced decode steps, the top-40
logits, logsumexp and RMS of each step (the RMS over the 122,753 real
columns) and each weight leaf's path, shape and float64 sum. Takes ~19 s
and 3.8 GiB at its peak on the CPU in float32, ~22 s and 5.3 GiB in
bfloat16.
"""
from __future__ import annotations

import sys

from make_mamba2_130m_golden import cli

if __name__ == "__main__":
    sys.exit(cli("minicpm-2b", 8, "minicpm_2b"))
