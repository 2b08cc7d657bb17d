"""String pattern utilities (the port's copy of
`autognothi_tpu/utils/strings.py`): `{var}` template matching and rewriting
(`pattern_replace`, the engine of `utils/surgery.py`), `flatten_dict`, and
the checkpoint-cadence mini-DSL (`ranged_modulo_test`)."""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Tuple

__all__ = [
    "flatten_dict",
    "pattern_replace",
    "pattern_replace_single",
    "ranged_modulo_test",
]


def flatten_dict(d: Dict[str, Any], sep: str = ".") -> Dict[str, Any]:
    """Flatten nested dicts into a single level with `sep`-joined keys."""
    out: Dict[str, Any] = {}
    for key, val in d.items():
        if isinstance(val, dict):
            for sub_key, sub_val in flatten_dict(val, sep).items():
                out[f"{key}{sep}{sub_key}"] = sub_val
        else:
            out[key] = val
    return out


_TEMPLATE_VAR = re.compile(r"\{([^{}]*)\}")


def _template_to_parts(template: str) -> List[Tuple[bool, str]]:
    """Split ``"a.{i}.b"`` into [(False, "a."), (True, "i"), (False, ".b")]."""
    parts: List[Tuple[bool, str]] = []
    cursor = 0
    for m in _TEMPLATE_VAR.finditer(template):
        if m.start() > cursor:
            parts.append((False, template[cursor : m.start()]))
        parts.append((True, m.group(1)))
        cursor = m.end()
    if cursor < len(template):
        parts.append((False, template[cursor:]))
    return parts


def pattern_replace_single(
    src_template: str, dst_template: str
) -> Callable[[str], Tuple[bool, str]]:
    """Build a rewriter: text matching `src_template` (full match, `{var}`
    slots are non-greedy wildcards) is rewritten into `dst_template` with the
    captured variables substituted.  Non-matching text is returned unchanged
    with a False flag."""

    src_parts = _template_to_parts(src_template)
    dst_parts = _template_to_parts(dst_template)

    regex_str = ""
    var_order: List[str] = []
    for is_var, chunk in src_parts:
        if is_var:
            regex_str += r"(.*?)"
            var_order.append(chunk)
        else:
            regex_str += re.escape(chunk)
    regex = re.compile(regex_str)

    def rewrite(text: str) -> Tuple[bool, str]:
        m = regex.fullmatch(text)
        if m is None:
            return False, text
        captured = dict(zip(var_order, m.groups()))
        pieces: List[str] = []
        for is_var, chunk in dst_parts:
            pieces.append(captured[chunk] if is_var else chunk)
        return True, "".join(pieces)

    return rewrite


def pattern_replace(
    rules: Dict[str, List[str]],
) -> Callable[[str], Tuple[bool, List[str]]]:
    """Build a multi-rule rewriter.  Each rule maps one source template to a
    list of destination templates (fan-out).  The first rule whose *every*
    destination rewrite matches wins; an empty destination list yields the
    input text itself."""

    compiled: List[List[Callable[[str], Tuple[bool, str]]]] = []
    for src, dsts in rules.items():
        compiled.append([pattern_replace_single(src, dst) for dst in dsts])

    def rewrite(text: str) -> Tuple[bool, List[str]]:
        for rule in compiled:
            outputs: List[str] = []
            matched_all = True
            for fn in rule:
                ok, out = fn(text)
                if ok:
                    outputs.append(out)
                else:
                    matched_all = False
            if matched_all:
                return True, outputs or [text]
        return False, [text]

    return rewrite


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
