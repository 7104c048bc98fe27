"""``psel``: data0 where the 1-bit bit0 is high, else data1; a word."""
import numpy as np

WIDTH = 16


def apply(port):
    return np.where(np.asarray(port("bit0")) & 1, port("data0"),
                    port("data1"))
