from .apply import OpBatch, apply_ops
from .merge import TableState, init_table, merge_tables, merge_tables_torch

__all__ = [
    "TableState",
    "init_table",
    "merge_tables",
    "merge_tables_torch",
    "OpBatch",
    "apply_ops",
]
