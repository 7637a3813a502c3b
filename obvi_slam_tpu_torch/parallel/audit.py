"""What the collectives of a run move: op counts, bytes and shapes.

Counterpart of ``obvi_slam_tpu/parallel/audit.py``. The reference reads its
collectives out of compiled HLO; here every collective goes through
``parallel.comm``, which reports each one to ``record``, and a ``recording()``
block keeps them. ``collect_collectives`` returns ``{op: {count, bytes,
shapes}}`` in the reference's shape, with the reference's op names
("all-reduce", "all-gather") and "broadcast". An all-gather counts its
gathered result, as the reference counts the HLO op's result shape.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

_DTYPE_NAMES = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
                torch.int32: "s32", torch.int64: "s64", torch.bool: "pred",
                torch.uint8: "u8"}
# Open recordings; each collective is appended to every one of them.
_active: list = []


def record(op: str, dtype: torch.dtype, shape) -> None:
    """Notes one collective (called by ``parallel.comm``)."""
    if _active:
        entry = (op, dtype, tuple(int(d) for d in shape))
        for records in _active:
            records.append(entry)


@contextmanager
def recording():
    """Yields a list that receives (op, dtype, shape) of every collective
    issued inside the block."""
    records: list = []
    _active.append(records)
    try:
        yield records
    finally:
        _active.remove(records)


def collect_collectives(records) -> dict:
    """Per-op {count, bytes, shapes} from ``recording()``'s list; at most 16
    shapes per op are listed, as in the reference."""
    by_op: dict = {}
    for op, dtype, shape in records:
        rec = by_op.setdefault(op, {"count": 0, "bytes": 0, "shapes": []})
        rec["count"] += 1
        n = 1
        for d in shape:
            n *= d
        rec["bytes"] += n * torch.empty((), dtype=dtype).element_size()
        if len(rec["shapes"]) < 16:
            dims = ",".join(str(d) for d in shape)
            rec["shapes"].append(f"{_DTYPE_NAMES.get(dtype, str(dtype))}[{dims}]")
    return by_op


def all_reduce_bytes(by_op: dict) -> int:
    return sum(by_op.get(op, {}).get("bytes", 0) for op in ("all-reduce", "reduce-scatter"))
