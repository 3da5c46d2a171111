"""Step builders of the LM stack (serving only so far)."""
