"""``ess_per_s`` (1/s, host clock): the total ESS of the predictive mean
(``sampling.predictive_ess``), summed over the window's jobs, over the
window's wall."""


def read(record):
    if "ess_total" not in record:
        return None
    return record["ess_total"] / record["window_s"]
