"""Step builders of the LM stack: training and serving."""
