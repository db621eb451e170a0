"""YAML configs, read with PyYAML's ``safe_load``, and their validation
against dataclasses.

The port's own copy of ``unified_audio_tpu/utils/config.py``: ``load_yaml``,
``from_dict`` (unknown keys refused, nested dataclasses built, lists
made tuples), ``load_config`` (the two together) and ``to_dict``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type, TypeVar

import yaml

T = TypeVar("T")


def load_yaml(path) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Build a (possibly nested) dataclass from a dict, erroring on unknown
    keys and coercing nested dataclass fields."""
    if not dataclasses.is_dataclass(cls):
        return data  # type: ignore[return-value]
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, value in data.items():
        f = fields[name]
        ftype = f.type
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[name] = from_dict(ftype, value)
        elif isinstance(value, list):
            kwargs[name] = tuple(value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def load_config(path, cls: Type[T]) -> T:
    """A YAML file -> the dataclass ``cls`` (:func:`from_dict`)."""
    return from_dict(cls, load_yaml(path))


def to_dict(obj) -> Dict[str, Any]:
    """A (nested) dataclass -> plain dicts."""
    return dataclasses.asdict(obj)
