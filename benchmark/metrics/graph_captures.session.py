"""CUDA graphs the fused solves captured inside the window: the change in
``lm_fused.graph_stats["captures"]``."""


def read(record):
    stats = record.get("graph_stats")
    if not stats or "captures" not in stats:
        return None
    return stats["captures"]
