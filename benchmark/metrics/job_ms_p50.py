"""The median of the jobs' wall times, ms: the host clock around
``__main__.run``, which returns after the exports are written; failed jobs
included."""

import numpy as np


def read(run):
    if not run.jobs:
        return None
    return float(np.median([j.wall_s for j in run.jobs])) * 1e3
