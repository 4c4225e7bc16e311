"""Set-up seconds: the process's start (before torch is imported) to the
window's start: imports, the kernels' load (their build on a first run),
weights, inputs and the warm-up."""


def read(rec):
    return rec.setup_s
