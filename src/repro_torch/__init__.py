"""PyTorch + CUDA port of the out-of-order dataflow overlay simulator.

A second package beside the JAX reference (``repro``), with the same module
layout, that never imports it. It runs the overlay simulation (:func:`run`),
on one device or with the PE grid tiled over a mesh of devices
(:mod:`repro_torch.core.distributed`), on an NVIDIA Hopper card, with the
scheduler's leading-one pick in hand-written CUDA kernels
(:mod:`repro_torch.kernels.lod`) or the whole chunk in one
(:mod:`repro_torch.kernels.megakernel`), traces it on request
(:mod:`repro_torch.telemetry`), and reproduces the reference's results bit
for bit.
"""
from .api import run

__all__ = ["run"]
