"""wrap_pad_share.solve: percent of the device's busy time in the
concatenations that build the solver's periodic wrap pad
(``compiler/codegen.py::_wrap_pad``)."""
from fieldbench.readers import share_of_busy


def read(run):
    return share_of_busy(run, lambda n: "CatArrayBatchedCopy" in n)
