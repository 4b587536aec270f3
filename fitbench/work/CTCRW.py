"""The bytes one nllk+grad of the CTCRW must move, whatever kernels do it:
the observations (rows x dims), the time steps (rows), the per-row
parameter matrix (rows x (dims + 2): each mean, then tau and nu) and its
per-row gradient (the same), each read or written once."""


def eval_bytes(rows, dims, itemsize):
    params = dims + 2
    return rows * (dims + 1 + 2 * params) * itemsize
