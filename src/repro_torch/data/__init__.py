"""The training data pipeline (the reference package's ``repro.data``)."""
