"""``peer_sum_ms`` (ms an epoch; layer: mesh): the device time of the
copies between cards (``DataPeers.sum``'s exchange) in the profiled
sub-window, over its epochs."""

import profiling


def read(record):
    chunks = record.get("profile_chunks")
    if not chunks or record["shape"]["cards"] < 2:
        return None
    seconds, n = profiling.kernel_seconds(record["profile_events"],
                                      r"Memcpy PtoP|Memcpy DtoD \(Device -> Device\)")
    if n == 0:
        return None
    return 1e3 * seconds / sum(epochs for epochs, _ in chunks)
