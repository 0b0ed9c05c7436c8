"""Bytes and operations of one `sparse_row_dots` launch (the port's
`row_dots_kernel`): the masked row dots of a (rows, nnz) padded-CSR batch
with a (d,) float32 coefficient.

Each input byte is counted read once and each output byte written once:
the int32 indices and float32 values of every slot, the coefficient once
(at these shapes nearly every column is gathered: 1 - exp(-rows * nnz / d)
of them), and the (rows,) float32 dots. A multiply and an add a slot.
"""


def count(rows: int, nnz: int, d: int):
    """(bytes, operations)."""
    slots = rows * nnz
    return slots * (4 + 4) + d * 4 + rows * 4, 2 * slots
