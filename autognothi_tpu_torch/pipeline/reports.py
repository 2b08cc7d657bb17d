"""The reports' JSON rules: the port's reports are dataclasses, written and
read so that a report file of either package loads in the other.

The JAX package writes a pydantic report with
`model_dump_json(by_alias=True, exclude_unset=True)`, re-indented by `json`
(`autognothi_tpu/pipeline/measure_all.py:load_or_run_report`).  Its reports
set every field they have, so `dump_report` writes:
- every field, in the dataclass's field order;
- an explicit None as `null`;
- int dict keys as strings, as pydantic does;
- floats as Python's `repr`, which is what `json` makes of pydantic's
  output when it re-indents it, and a NaN or infinity as `null`, as
  pydantic writes it.

`load_report` is the reverse, and validates as it goes: every key must be a
field (a field with a default may be missing), every value of its type
(an int is taken for a float, a string key for an int key, as pydantic's
lax mode takes them), nested dataclasses and lists and dicts of them
included; anything else raises ValueError naming the path.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import typing
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")


def to_json(obj: Any) -> Any:
    """A report (dataclasses, lists, dicts, numbers, strings, None) -> the
    JSON value the JAX package writes for it."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_json(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): to_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_json(v) for v in obj]
    if isinstance(obj, bool) or obj is None or isinstance(obj, str):
        return obj
    if isinstance(obj, int):
        return int(obj)
    if isinstance(obj, float):
        # pydantic writes a non-finite float as null (ser_json_inf_nan)
        return float(obj) if math.isfinite(obj) else None
    raise TypeError(f"a report holds no {type(obj).__name__}: {obj!r}")


def dump_report(report: Any) -> str:
    """The report file's text: indented JSON and a final newline."""
    return json.dumps(to_json(report), indent=2) + "\n"


@functools.lru_cache(maxsize=None)
def _hints(cls: type) -> Dict[str, Any]:
    return typing.get_type_hints(cls)


def _fail(path: str, want: str, value: Any) -> ValueError:
    return ValueError(f"report field {path or '<root>'}: expected {want}, "
                      f"got {value!r}"[:300])


def _load(tp: Any, value: Any, path: str) -> Any:
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if tp is Any:
        return value
    if origin is typing.Union:
        if value is None and type(None) in args:
            return None
        rest = [a for a in args if a is not type(None)]
        if len(rest) != 1:
            raise TypeError(f"unsupported union {tp} at {path}")
        return _load(rest[0], value, path)
    if dataclasses.is_dataclass(tp):
        if not isinstance(value, dict):
            raise _fail(path, tp.__name__, value)
        fields = {f.name: f for f in dataclasses.fields(tp)}
        extra = sorted(set(value) - set(fields))
        if extra:
            raise ValueError(f"report field {path or '<root>'}: unknown "
                             f"keys {extra} for {tp.__name__}")
        hints = _hints(tp)
        kw = {}
        for name, f in fields.items():
            sub = f"{path}.{name}" if path else name
            if name not in value:
                if f.default is dataclasses.MISSING and \
                        f.default_factory is dataclasses.MISSING:
                    raise ValueError(f"report field {sub}: missing")
                continue
            kw[name] = _load(hints[name], value[name], sub)
        return tp(**kw)
    if origin in (list, typing.List):
        if not isinstance(value, list):
            raise _fail(path, "a list", value)
        return [_load(args[0], v, f"{path}[{i}]") for i, v in
                enumerate(value)]
    if origin in (dict, typing.Dict):
        if not isinstance(value, dict):
            raise _fail(path, "an object", value)
        return {_load_key(args[0], k, path): _load(args[1], v,
                                                   f"{path}[{k}]")
                for k, v in value.items()}
    if tp is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise _fail(path, "a number", value)
        return float(value)
    if tp is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise _fail(path, "an integer", value)
        return value
    if tp is str:
        if not isinstance(value, str):
            raise _fail(path, "a string", value)
        return value
    if tp is bool:
        if not isinstance(value, bool):
            raise _fail(path, "a boolean", value)
        return value
    raise TypeError(f"unsupported report type {tp} at {path}")


def _load_key(tp: Any, key: str, path: str) -> Any:
    if tp is int:
        try:
            return int(key)
        except ValueError:
            raise _fail(f"{path} key", "an integer", key) from None
    if tp is str:
        return key
    raise TypeError(f"unsupported report key type {tp} at {path}")


def load_report(cls: Type[T], data: Any) -> T:
    """A report's JSON value -> the report, validated (see the module
    docstring); ValueError on a mismatch."""
    return _load(cls, data, "")
