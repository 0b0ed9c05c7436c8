"""Bytes and operations of one `sparse_grad` launch (the port's
`sparse_grad_kernel`): the gradient segment sum of a (rows, nnz)
padded-CSR batch, each slot's value times its row's multiplier added into
a (d,) float32 gradient.

Each input byte is counted read once and each output byte written once:
the int32 indices and float32 values of every slot, the (rows,) float32
multipliers, and the (d,) gradient written once (the fill that zeroes it
first is a kernel of its own). A multiply and an add a slot.
"""


def count(rows: int, nnz: int, d: int):
    """(bytes, operations)."""
    slots = rows * nnz
    return slots * (4 + 4) + rows * 4 + d * 4, 2 * slots
