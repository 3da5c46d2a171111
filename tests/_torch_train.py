"""Shared inputs of the port's training tests (``tests/test_torch_train_*.py``).

Both sides build the same numpy inputs from seeds: the weights of
:func:`repro_torch.convert.numpy_lm_params`, and batches from the copy task
of the data pipeline (the reference's and the port's give the same bits),
plus a VLM's stub patch embeddings or whisper's stub frames. The reference
side runs in a subprocess (``tests/_torch_ref.run_reference``), which puts
``tests`` on its path and imports this module.
"""
from __future__ import annotations

import numpy as np

#: One registry arch of each family, and the kind of batch it takes.
FAMILIES = {"dense": "qwen2-0.5b", "moe_mla": "deepseek-v2-lite-16b",
            "vlm": "qwen2-vl-72b", "ssm": "mamba2-130m",
            "hybrid": "zamba2-7b", "encdec": "whisper-large-v3"}

#: Flattens a reference-layout tree (dicts, lists, None) in the reference
#: subprocess; ``flat`` below is the same walk in the test process.
FLAT = '''
def flat(tree, prefix=""):
    out = {}
    if tree is None:
        return out
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix[:-1]: np.asarray(tree, dtype=np.float32)}
    for k, v in items:
        out.update(flat(v, f"{prefix}{k}/"))
    return out
'''
exec(FLAT)


def lm_batch(cfg, batch: int = 2, seq: int = 16, seed: int = 0,
             copy_task=None) -> dict:
    """A batch of numpy arrays: ``tokens``, ``labels`` and ``mask`` of the
    copy task at step 0 (``copy_task``: the pipeline's class, the
    reference's or the port's; t tokens, ``seq`` or ``seq - 1``), with
    ``embeds`` ``[batch, t, d]`` in place of ``tokens`` for a VLM and
    ``frames`` ``[batch, 2 t, d]`` added for an encoder-decoder, drawn
    from ``default_rng(seed + 1)``."""
    if copy_task is None:
        from repro_torch.data.pipeline import SyntheticCopyTask as copy_task
    b = copy_task(cfg.vocab_size, batch=batch, seq=seq, seed=seed).batch_at(0)
    t = b["tokens"].shape[1]           # the copy task gives seq - 1 when even
    rng = np.random.default_rng(seed + 1)
    if cfg.encdec is not None:
        b["frames"] = rng.standard_normal((batch, 2 * t, cfg.d_model),
                                          dtype=np.float32)
    elif cfg.family == "vlm":
        b["embeds"] = rng.standard_normal((batch, t, cfg.d_model),
                                          dtype=np.float32)
        del b["tokens"]
    return b
