"""Host ms per window frame in the sliding-window BA: the program's build and
solve timers of local windows (``phase_one_lba_*``, ``phase_two_lba_*``; a
solve's timer ends in its flag read, so it covers the device work)."""

import re

_LOCAL = re.compile(r"^phase_(one|two)_lba_(build|solve)_opt$")


def read(record):
    if not record.get("frames"):
        return None
    total = sum(v for k, v in record["timers"].items() if _LOCAL.match(k))
    return total * 1e3 / record["frames"]
