"""Config classes as dataclasses, for configs read from TOML with `tomllib`.

The JAX package's configs are pydantic models; the port uses the standard
library only (the card's machine has no pydantic). What the port keeps of
pydantic's behaviour:

- a subclass of `Config` is a dataclass without a decorator, and its fields
  are keyword-only, so a subclass may add fields without defaults;
- a config instance given as a field default is copied per instance;
- a dict given for a field typed as a `Config` subclass is built into one;
- unknown keys are refused, as ``extra="forbid"`` does, except by a class
  that sets ``allow_extra = True`` (``extra="allow"``: the logger configs),
  which keeps them as attributes;
- a field made with `parsed` converts its value (a TOML string, say) when
  the instance is built;
- iterating over a config yields its (field name, value) pairs.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import typing
from typing import Any, Callable, ClassVar, Iterator, TypeVar

T = TypeVar("T", bound="Config")


def parsed(parse: Callable[[Any], Any], default: Any = dataclasses.MISSING, factory: Any = dataclasses.MISSING) -> Any:
    """A field whose value goes through `parse` when the config is built
    (None is left as it is)."""
    return dataclasses.field(default=default, default_factory=factory, metadata={"parse": parse})


@functools.cache
def _field_types(cls: type) -> dict[str, Any]:
    try:
        hints = typing.get_type_hints(cls)
    except NameError:  # a class defined in a function, with string annotations
        hints = {}
    return {f.name: hints.get(f.name, f.type) for f in dataclasses.fields(cls)}


class Config:
    """Base of every config class."""

    allow_extra: ClassVar[bool] = False

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        for name, value in list(vars(cls).items()):
            if isinstance(value, Config):
                setattr(cls, name, dataclasses.field(default_factory=functools.partial(copy.deepcopy, value)))
        dataclasses.dataclass(cls, kw_only=True)

    def __post_init__(self) -> None:
        types = _field_types(type(self))
        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            value = getattr(self, f.name)
            parse = f.metadata.get("parse")
            field_type = types[f.name]
            if parse is not None and value is not None:
                setattr(self, f.name, parse(value))
            elif isinstance(value, dict) and isinstance(field_type, type) and issubclass(field_type, Config):
                setattr(self, f.name, field_type.from_dict(value))

    @classmethod
    def from_dict(cls: type[T], data: dict[str, Any]) -> T:
        names = {f.name for f in dataclasses.fields(cls)}  # type: ignore[arg-type]
        unknown = sorted(set(data) - names)
        if unknown and not cls.allow_extra:
            raise ValueError(f"{cls.__name__}: unknown keys {unknown} (known: {sorted(names)})")
        config = cls(**{k: v for k, v in data.items() if k in names})
        for key in unknown:
            setattr(config, key, data[key])
        return config

    def __iter__(self) -> Iterator[tuple[str, Any]]:
        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            yield f.name, getattr(self, f.name)
