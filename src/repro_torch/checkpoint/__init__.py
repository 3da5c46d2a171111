"""Checkpoints of the train state (the reference package's ``repro.checkpoint``)."""
