"""The checkpoint-cadence mini-DSL (the port's copy of
`autognothi_tpu/utils/strings.py:ranged_modulo_test`)."""

from __future__ import annotations

import re
from typing import Callable, List, Tuple

_RANGED_RULE = re.compile(r"<=\s*(\d+)\s*:\s*%\s*(\d+)\s*==\s*(\d+)")
_OPEN_RULE = re.compile(r"_\s*:\s*%\s*(\d+)\s*==\s*(\d+)")
_OPEN_BOUND = 10**9


def ranged_modulo_test(pattern: str) -> Callable[[int], bool]:
    """Parse a checkpoint-cadence expression into a predicate.

    Grammar: semicolon-separated clauses, each either ``<=B:%M==R`` (applies
    to numbers in the bucket ending at B) or ``_:%M==R`` (open-ended bucket).
    Buckets are sorted by bound; each covers (previous bound, its bound].
    A number matches if it falls in some bucket and satisfies that bucket's
    modulo test.
    """
    raw: List[Tuple[int, int, int]] = []
    for clause in (c.strip() for c in pattern.split(";")):
        if not clause:
            continue
        bounded = _RANGED_RULE.findall(clause)
        open_ended = _OPEN_RULE.findall(clause)
        if bounded:
            bound, mod, rem = (int(x) for x in bounded[0])
        elif open_ended:
            bound = _OPEN_BOUND
            mod, rem = (int(x) for x in open_ended[0])
        else:
            raise ValueError(f"invalid ckpt cadence pattern: {pattern!r}")
        if mod == 0:
            raise ValueError(
                f"zero modulus in ckpt cadence pattern: {pattern!r}")
        raw.append((bound, mod, rem))
    raw.sort(key=lambda t: t[0])

    buckets: List[Tuple[int, int, int, int]] = []  # (low, high, mod, rem)
    low = 0
    for bound, mod, rem in raw:
        buckets.append((low, bound, mod, rem))
        low = bound + 1

    def test(num: int) -> bool:
        return any(lo <= num <= hi and num % mod == rem
                   for lo, hi, mod, rem in buckets)

    return test
