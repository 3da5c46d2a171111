"""The LM stack: config schema, attention, blocks and the language model."""
