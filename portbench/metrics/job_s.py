"""job_s: the window's length over the jobs it completed (s), the time a
user waits for one comparison in a closed loop of back-to-back jobs."""


def read(rec):
    done = sum(j["ok"] for j in rec["jobs"])
    lo, hi = rec["window"]
    return (hi - lo) / done if done else None
