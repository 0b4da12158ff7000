"""Value/metadata primitives for the typed provider state.

Mirrors the reference's ``iacTypes`` (pkg/iac/types): every scalar a
check can reason about is wrapped in a value object carrying the source
range it was adapted from and whether it was written explicitly,
defaulted, or unresolvable (a cross-resource reference the parser could
not follow).  ``to_rego`` lowers the whole tree to the exact dict shape
the reference's rego convert layer produces (pkg/iac/rego/convert):

- struct field ``FooBar``/``foo_bar`` -> key ``foobar`` (lowercased,
  underscores dropped), so check paths like
  ``bucket.publicaccessblock.blockpublicacls`` resolve;
- a struct's own metadata nests under ``__defsec_metadata__``;
- a value object becomes ``{"value": ..., "filepath": ...,
  "startline": ..., "endline": ..., "managed": ..., "explicit": ...,
  "unresolvable": ..., "fskey": ..., "resource": ..., "sourceprefix":
  ...}`` — what ``result.new`` reads back for finding locations.

Copied from `trivy_tpu/iac/providers/types.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class Range:
    filename: str = ""
    start_line: int = 0
    end_line: int = 0


@dataclass(frozen=True)
class Metadata:
    rng: Range = field(default_factory=Range)
    # terraform address / CFN logical id / cloud ARN of the enclosing
    # resource — surfaces in rego as "resource".
    reference: str = ""
    managed: bool = True
    explicit: bool = False
    unresolvable: bool = False

    def with_(self, **kw: Any) -> "Metadata":
        return dataclasses.replace(self, **kw)

    def to_rego(self) -> dict:
        return {
            "filepath": self.rng.filename,
            "startline": self.rng.start_line,
            "endline": self.rng.end_line,
            "sourceprefix": "",
            "managed": self.managed,
            "explicit": self.explicit,
            "unresolvable": self.unresolvable,
            "fskey": "",
            "resource": self.reference,
        }


class Value:
    """A scalar plus the metadata of where it came from."""

    __slots__ = ("value", "metadata")

    def __init__(self, value: Any, metadata: Metadata):
        self.value = value
        self.metadata = metadata

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}({self.value!r})"

    def to_rego(self) -> dict:
        d = self.metadata.to_rego()
        d["value"] = self.value
        return d


class BoolValue(Value):
    pass


class StringValue(Value):
    pass


class IntValue(Value):
    pass


def Bool(value: Any, metadata: Metadata, explicit: bool = True) -> BoolValue:
    return BoolValue(bool(value), metadata.with_(explicit=explicit))


def BoolDefault(value: Any, metadata: Metadata) -> BoolValue:
    return BoolValue(bool(value), metadata.with_(explicit=False))


def String(value: Any, metadata: Metadata, explicit: bool = True) -> StringValue:
    return StringValue("" if value is None else str(value),
                       metadata.with_(explicit=explicit))


def StringDefault(value: Any, metadata: Metadata) -> StringValue:
    return StringValue("" if value is None else str(value),
                       metadata.with_(explicit=False))


def Int(value: Any, metadata: Metadata, explicit: bool = True) -> IntValue:
    try:
        iv = int(value)
    except (TypeError, ValueError):
        iv = 0
    return IntValue(iv, metadata.with_(explicit=explicit))


def IntDefault(value: Any, metadata: Metadata) -> IntValue:
    return Int(value, metadata, explicit=False)


def StringUnresolvable(metadata: Metadata) -> StringValue:
    return StringValue("", metadata.with_(unresolvable=True))


def to_rego(obj: Any) -> Any:
    """Lower a provider-state tree (dataclasses / value objects / lists)
    to the plain-dict document rego checks evaluate against."""
    if isinstance(obj, Value):
        return obj.to_rego()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out: dict = {}
        md = getattr(obj, "metadata", None)
        if isinstance(md, Metadata):
            out["__defsec_metadata__"] = md.to_rego()
        for f in dataclasses.fields(obj):
            if f.name == "metadata":
                continue
            v = getattr(obj, f.name)
            if v is None:
                continue
            out[f.name.replace("_", "").lower()] = to_rego(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [to_rego(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_rego(v) for k, v in obj.items()}
    return obj
