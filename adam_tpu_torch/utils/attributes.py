"""SAM attribute (optional tag) parsing.

Copied from ``adam_tpu/utils/attributes.py`` (host code).

Parity with ``models/Attribute.scala:50`` + ``util/AttributeUtils.scala:103``:
``TAG:TYPE:VALUE`` strings parse to typed :class:`Attribute` values, the
SAM spec types A/i/f/Z/H/B map to :class:`TagType`, and ``str()`` of an
Attribute reproduces the SAM text form.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass
from typing import Any


class TagType(enum.Enum):
    CHARACTER = "A"
    INTEGER = "i"
    FLOAT = "f"
    STRING = "Z"
    BYTE_SEQUENCE = "H"
    NUMERIC_SEQUENCE = "B"


@dataclass(frozen=True)
class Attribute:
    tag: str
    tag_type: TagType
    value: Any

    def __str__(self) -> str:
        if self.tag_type is TagType.NUMERIC_SEQUENCE:
            # B values re-emit with their array subtype prefix
            sub, vals = self.value
            body = ",".join(str(v) for v in vals)
            return f"{self.tag}:B:{sub},{body}"
        return f"{self.tag}:{self.tag_type.value}:{self.value}"


_ATTR_RE = re.compile(r"^([^:]{2}):([AifZHB]):(.*)$")


def parse_attribute(encoded: str) -> Attribute:
    """One ``TAG:TYPE:VALUE`` token -> Attribute
    (AttributeUtils.parseAttribute, :60-67)."""
    m = _ATTR_RE.match(encoded)
    if not m:
        raise ValueError(
            f'attribute string "{encoded}" doesn\'t match format '
            f"attrTuple:type:value"
        )
    tag, type_chr, value_str = m.groups()
    tag_type = TagType(type_chr)
    if tag_type is TagType.CHARACTER:
        if len(value_str) != 1:
            raise ValueError(
                f'A-type attribute "{encoded}" must carry exactly one '
                f"character"
            )
        value: Any = value_str
    elif tag_type is TagType.INTEGER:
        value = int(value_str)
    elif tag_type is TagType.FLOAT:
        value = float(value_str)
    elif tag_type is TagType.STRING:
        value = value_str
    elif tag_type is TagType.BYTE_SEQUENCE:
        value = bytes.fromhex(value_str)
    else:  # NUMERIC_SEQUENCE: "subtype,v1,v2,..."
        parts = value_str.split(",")
        sub, items = parts[0], parts[1:]
        nums = [float(v) if "." in v else int(v) for v in items]
        value = (sub, nums)
    return Attribute(tag, tag_type, value)


def parse_attributes(tag_strings: str) -> list[Attribute]:
    """Tab-separated tag tokens -> Attributes
    (AttributeUtils.parseAttributes, :53-55)."""
    return [
        parse_attribute(tok)
        for tok in tag_strings.split("\t")
        if len(tok) > 0
    ]
