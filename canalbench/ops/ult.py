"""``ult``: data0 < data1, compared as unsigned 16-bit words; 1 bit."""
import numpy as np

WIDTH = 1


def apply(port):
    return (np.asarray(port("data0")) < np.asarray(port("data1"))) * 1
