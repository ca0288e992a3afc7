"""``leapfrog_steps_per_s`` (steps/s, host clock): every main-block
leapfrog step the window's jobs executed, over all chains (each chain at
its own group's L), over the window's wall, which holds the captures, the
hyper block and the driver's host work."""


def read(record):
    jobs = record.get("jobs")
    if not jobs:
        return None
    return sum(j["steps"] for j in jobs) / record["window_s"]
