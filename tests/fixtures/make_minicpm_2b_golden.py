"""Write ``minicpm_2b_golden.npz``: the reference LM's logits for
minicpm-2b at full width cut to 8 layers, float32, the golden that
``chip_smoke.py`` holds the port against on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fixtures/make_minicpm_2b_golden.py

minicpm-2b's full config (d_model 2304, 36 heads over 36 kv heads of 64
(MHA), SwiGLU at d_ff 5760, vocab 122,753 padded to 122,880 with the head
tied to the embedding) cut to its first 8 of 40 layers (~772 M
parameters). Otherwise as ``make_mamba2_130m_golden.py`` (whose
:func:`make` this runs): float32, the recipe's weights from seed 0, a batch
of 2 prompts of 300 tokens and 3 teacher-forced decode steps, the top-40
logits, logsumexp and RMS of each step (the RMS over the 122,753 real
columns) and each weight leaf's path, shape and float64 sum. Takes ~30 s
and 4.9 GB at its peak on the CPU.
"""
from __future__ import annotations

import sys
from pathlib import Path

from make_mamba2_130m_golden import make


def main() -> int:
    make("minicpm-2b", 8, Path(__file__).with_name("minicpm_2b_golden.npz"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
