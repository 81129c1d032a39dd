"""
Binomial / multinomial helpers for polyploid read scoring.

Behavior parity with the reference's src/binomial.cpp and
src/multinomial.cpp, including the incremental product accumulation
(so floating point results match the C++ to the last bit for the
same inputs).
"""

import math
from typing import List, Sequence

_DBL_MAX = 1.7976931348623157e308


def binomial_coefficient(n: int, k: int) -> int:
    # src/binomial.cpp:5-15 (integer division in the loop like the C++)
    if k < 0 or n < 0 or n < k:
        return 0
    result = 1
    if k > n - k:
        k = n - k
    for i in range(k):
        result = result * (n - i)
        result = result // (i + 1)
    return result


def binomial_coefficient_log(n: int, k: int) -> float:
    # src/binomial.cpp:17-34: intertwined product with overflow-triggered logs
    if k < 0 or n < 0 or n < k:
        return 0.0
    result = 0.0
    if k > n - k:
        k = n - k
    buffer = 1.0
    for i in range(k):
        addition = float(n - i) / float(i + 1)
        if buffer * addition > _DBL_MAX:
            result += math.log(buffer)
            buffer = addition
        else:
            buffer *= addition
    return result + math.log(buffer)


def binom_pmf(n: int, k: int, p: float) -> float:
    return math.exp(binomial_coefficient_log(n, k)) * (p ** k) * ((1 - p) ** (n - k))


def log_binom_pmf(n: int, k: int, p: float) -> float:
    # note: k*log(0) may produce -inf / nan exactly like the C++
    try:
        logp = math.log(p) if p > 0 else float("-inf")
        log1p_ = math.log(1 - p) if (1 - p) > 0 else float("-inf")
    except ValueError:  # pragma: no cover
        return float("nan")
    val = binomial_coefficient_log(n, k)
    val += k * logp if k != 0 else 0.0
    val += (n - k) * log1p_ if (n - k) != 0 else 0.0
    return val


def log_multinomial_coefficient(n: Sequence[int]) -> float:
    # src/multinomial.cpp:8-36
    s: List[int] = sorted(n, reverse=True)
    total = s[0]
    factors: List[int] = []
    for i in range(1, len(s)):
        total += s[i]
        for j in range(2, s[i] + 1):
            factors.append(j)
    result = 0.0
    buffer = 1.0
    for f in factors:
        addition = float(total - s[0]) / float(f)
        if buffer * addition > _DBL_MAX:
            result += math.log(buffer)
            buffer = addition
        else:
            buffer *= addition
    return result + math.log(buffer)


def check_multinom_input(n: Sequence[int], p: Sequence[float]) -> bool:
    if len(n) != len(p):
        return False
    return math.fsum(p) == 1.0 or sum(p) == 1.0


def multinom_pmf(n: Sequence[int], p: Sequence[float]) -> float:
    if len(n) == 2:
        return binom_pmf(n[0] + n[1], n[0], p[0])
    if not _check(n, p):
        return 0.0
    result = math.exp(log_multinomial_coefficient(n))
    for x in p:
        result *= x
    return result


def _check(n: Sequence[int], p: Sequence[float]) -> bool:
    # src/multinomial.cpp:38-47 (plain left-to-right sum, compared to 1.0)
    if len(n) != len(p):
        return False
    total = p[0]
    for i in range(1, len(p)):
        total += p[i]
    return total == 1.0


def log_multinom_pmf(n: Sequence[int], p: Sequence[float]) -> float:
    # src/multinomial.cpp:60-68
    if len(n) == 2:
        return log_binom_pmf(n[0] + n[1], n[0], p[0])
    if not _check(n, p):
        return 0.0
    result = log_multinomial_coefficient(n)
    for x in p:
        result += math.log(x) if x > 0 else float("-inf")
    return result
