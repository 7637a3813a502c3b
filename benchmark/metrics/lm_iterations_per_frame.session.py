"""LM iterations per window frame of the fused solves (window BAs, PGO
family, mini-BAs; each phase of a two-phase solve): the change in
``lm_fused.graph_stats["lm_iterations"]`` over the window's frames. Tells a
change in convergence from a change in speed. Nothing where the program has
no such counter."""


def read(record):
    stats = record.get("graph_stats")
    if not record.get("frames") or not stats or "lm_iterations" not in stats:
        return None
    return stats["lm_iterations"] / record["frames"]
