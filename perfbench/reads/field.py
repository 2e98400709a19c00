"""field: one field of a record at one peer. ``get`` of the leaf's path
returns its value; the reference's answer is that leaf's winner."""


def path(record_path: str, field: int) -> str:
    return f"{record_path}/field{field}"


def answer(row, field: int) -> float:
    """``row``: the reference's value of each of the record's fields."""
    return float(row[field])
