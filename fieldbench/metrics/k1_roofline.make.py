"""k1_roofline.make: K1's share of its roofline in the explicit runs
(:func:`fieldbench.readers.k1_roofline`)."""
from fieldbench.readers import k1_roofline


def read(run):
    return k1_roofline(run)
