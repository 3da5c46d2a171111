"""The 90th percentile, over every call in the window, of the host wall time
of one ``repro_torch.run`` call (one simulation), from the call to its
result, in milliseconds."""
import numpy as np


def read(ctx):
    walls = [c.seconds for c in ctx["calls"]]
    return float(np.percentile(walls, 90)) * 1e3 if walls else None
