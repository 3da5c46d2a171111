"""Command-line drivers of the LM stack."""
