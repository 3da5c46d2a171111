"""Optimizer and learning-rate schedules of the LM stack (the reference
package's ``repro.optim``)."""
from .adamw import AdamW, OptState  # noqa: F401
from .schedule import cosine_schedule, wsd_schedule  # noqa: F401
