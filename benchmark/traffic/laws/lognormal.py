"""Log-normal lengths: the quantiles (i + 0.5) / n of a log-normal
distribution with the group's `median` and `sigma` (of the log)."""

import math
import statistics

ORDERED = False


def draw(params: dict, n: int):
    dist = statistics.NormalDist()
    return [params["median"] * math.exp(params["sigma"] * dist.inv_cdf((i + 0.5) / n))
            for i in range(n)]
