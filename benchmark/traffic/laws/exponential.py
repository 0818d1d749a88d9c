"""Poisson arrivals: the quantiles (i + 0.5) / n of the exponential gap
at the mix's `rate_per_s`."""

import math

ORDERED = False


def draw(params: dict, n: int):
    rate = params["rate_per_s"]
    return [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
