"""Write ``starcoder2_7b_golden.npz``: the reference LM's logits for
starcoder2-7b at full width cut to 2 layers, float32, the golden that
``chip_smoke.py`` holds the port against on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_starcoder2_7b_golden.py

starcoder2-7b's full config (d_model 4608, 36 query heads over 4 kv heads
of 128: groups of 9 rows; LayerNorm with biases, biases on q, k, v and the
out-projection, a plain GELU MLP (``mlp_glu=False``) at d_ff 18432 with
biases, vocab 49,152, an untied head) cut to its first 2 of 32 layers
(~887 M parameters). Otherwise as ``make_mamba2_130m_golden.py`` (whose
:func:`make` this runs): float32, the recipe's weights from seed 0 (its
biases zero and its norm weights one, as the reference's initialisers
make them), a batch of 2 prompts of 300 tokens and 3 teacher-forced decode
steps, the top-40 logits, logsumexp and RMS of each step and each weight
leaf's path, shape and float64 sum. Takes ~36 s and 7.6 GB at its peak on
the CPU.
"""
from __future__ import annotations

import sys
from pathlib import Path

from make_mamba2_130m_golden import make


def main() -> int:
    make("starcoder2-7b", 2,
         Path(__file__).with_name("starcoder2_7b_golden.npz"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
