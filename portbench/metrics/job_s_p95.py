"""job_s_p95: the 95th percentile of the walls of all jobs in the
window (s), failed ones included (linear interpolation between ranks)."""

import numpy as np


def read(rec):
    walls = [j["wall"] for j in rec["jobs"]]
    return float(np.percentile(walls, 95)) if walls else None
