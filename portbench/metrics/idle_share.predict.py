"""``idle_share.predict`` (%; layer: device): the share of the profiled
run of ``predict`` calls in which the card ran nothing."""


def read(record):
    if "profile_calls" not in record or not record.get("profile_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["profile_s"])
