"""Config block base with "auto" support, on dataclasses.

Mirrors ``deepspeed_tpu/runtime/config_utils.py``. The JAX package builds
its config blocks on pydantic, which the machine with the card does not
have; the port's blocks are dataclasses filled from plain dicts by
``DeepSpeedConfigModel.from_dict``:

- a field set to the literal ``"auto"`` keeps its default (the engine
  resolves it), as the JAX base filters such values before validation;
- keys that name no field are ignored (the JAX base allows extras);
- ``aliases`` maps alternative JSON keys onto fields;
- ``bounds`` holds ``(low, high)`` range checks, either side None, that
  raise ``ValueError`` like the JAX ``Field(ge=..., le=...)`` constraints;
- a field whose default is a block class is parsed from its sub-dict.
"""

import dataclasses
from typing import Any, Dict

AUTO_VALUE = "auto"


def is_auto(value):
    return isinstance(value, str) and value.lower() == AUTO_VALUE


class DeepSpeedConfigModel:
    """Mixin for ``@dataclasses.dataclass`` config blocks."""

    aliases: Dict[str, str] = {}
    bounds: Dict[str, tuple] = {}
    blocks: Dict[str, type] = {}

    @classmethod
    def from_dict(cls, data=None, **kw):
        data = {**(data or {}), **kw}
        names = {f.name for f in dataclasses.fields(cls)}
        known: Dict[str, Any] = {}
        for key, value in data.items():
            key = cls.aliases.get(key, key)
            if key not in names or is_auto(value):
                continue
            block = cls.blocks.get(key)
            if block is not None and isinstance(value, dict):
                value = block.from_dict(value)
            known[key] = value
        obj = cls(**known)
        obj.check_bounds()
        return obj

    def check_bounds(self):
        for name, (low, high) in self.bounds.items():
            value = getattr(self, name)
            if value is None:
                continue
            if (low is not None and value < low) or (high is not None and value > high):
                raise ValueError(f"{type(self).__name__}.{name} = {value!r} is outside "
                                 f"[{low}, {high}]")


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys when parsing the user's JSON config."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError("Duplicate keys {} found in config".format(keys))
    return d
