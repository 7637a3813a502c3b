"""Share of the traced solves' wall time in which no operation ran on the
device (torch.profiler's device records)."""

from benchmark.metrics_common import idle_percent as read  # noqa: F401
