"""``idle_share.sample`` (%; layer: device): the share of the profiled
sub-window in which a card ran nothing (1 - the union of its kernels',
copies' and fills' intervals over the window), mean over the cards."""


def read(record):
    if record.get("profile_chunks") is None or not record.get("profile_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["profile_s"])
