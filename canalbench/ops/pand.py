"""``pand``: bit0 and bit1, the PE's 1-bit inputs; 1 bit."""
import numpy as np

WIDTH = 1


def apply(port):
    return np.asarray(port("bit0")) & np.asarray(port("bit1"))
