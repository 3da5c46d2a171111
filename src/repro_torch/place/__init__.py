"""Placement helpers. Only the slot assigner is ported so far; import
:mod:`repro_torch.place.slots` directly."""
