"""Helpers shared by the generic-tier parity tests
(tests/test_torch_generic_*.py)."""
import re

import numpy as np

NUM = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")


def same_lines(a: str, b: str) -> None:
    """The same printed lines: the same text between the numbers (runs of
    blanks counted as one, since padding follows a number's width), and the
    numbers equal to their printed digits, or both below 1e-12 (a gradient
    norm at an optimum is rounding noise in either package)."""
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb) and len(la) > 0, (la, lb)
    for x, y in zip(la, lb):
        assert (re.sub(r"\s+", " ", NUM.sub("#", x))
                == re.sub(r"\s+", " ", NUM.sub("#", y))), (x, y)
        for u, v in zip(NUM.findall(x), NUM.findall(y)):
            u, v = float(u), float(v)
            assert (abs(u) < 1e-12 and abs(v) < 1e-12) or np.isclose(
                u, v, rtol=1e-3, atol=1e-12), (x, y)
