"""record: YCSB's read, a whole record at one peer. ``get`` of the record's
path returns its fields, ``{"field0": v0, ...}``; the reference's answer is
every field's winner."""


def path(record_path: str, field: int) -> str:
    return record_path


def answer(row, field: int) -> dict:
    """``row``: the reference's value of each of the record's fields."""
    return {f"field{j}": v for j, v in enumerate(row.tolist())}
