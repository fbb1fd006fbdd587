"""YAML experiment configs -> live object graphs.

The semantics of ``megreader_tpu/core/config.py``:

* an experiment YAML may carry ``import: [other.yaml, ...]``; the imports are
  loaded first (depth first, cycles refused) and the importing file's keys
  override theirs;
* dotted overrides (``{"experiment.batch_size": 64}``, from the command line
  by ``parse_cli_overrides``) are applied to the merged config;
* string values ``"$ref:path.to.node"`` are replaced by that node of the
  merged root;
* a mapping with a ``class:`` key is built by the class registered under that
  name (``core/registry.py``), its other keys (built first, recursively) as
  keyword arguments; lists are built item by item.

The card's machine has no PyYAML, so this module reads YAML with a reader of
its own (``parse_yaml``) for the subset that ``experiments/*.yaml`` use:
block mappings, block sequences (of scalars or of mappings), flow sequences
and mappings, full-line and trailing comments, plain, single- and
double-quoted scalars. Scalars resolve as PyYAML's ``safe_load`` resolves
them (YAML 1.1): ``1.0e-3`` is a float and ``1e-3`` a string,
``true``/``yes``/``on`` and ``false``/``no``/``off`` are booleans, ``~``,
``null`` and the empty value are None, ``0x1f``, ``017`` (octal) and
``1_000`` are integers. Anything outside the subset (anchors,
aliases, tags, block scalars, several documents, directives, merge keys,
timestamps, multi-line plain scalars) raises ``YAMLError`` naming the file
and the line.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from .registry import COMPONENTS


class YAMLError(ValueError):
    """The text is not in the YAML subset this reader takes."""


# --- scalars (PyYAML's YAML 1.1 implicit resolvers) ---------------------------

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TRUE = {"yes", "true", "on"}


def _sexagesimal(value: str, cast):
    digits = [cast(part) for part in value.split(":")]
    base, out = 1, 0
    for d in reversed(digits):
        out += d * base
        base *= 60
    return out


def _resolve_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _resolve_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str, where: str = "<string>") -> Any:
    """A plain (unquoted) scalar as ``yaml.safe_load`` resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return _resolve_int(text)
    if _FLOAT.match(text):
        return _resolve_float(text)
    if _TIMESTAMP.match(text):
        raise YAMLError(f"{where}: timestamps are outside the YAML subset: {text!r}")
    if text == "<<":
        raise YAMLError(f"{where}: merge keys are outside the YAML subset")
    return text


# --- the reader -----------------------------------------------------------------

_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_UNSUPPORTED = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
                ">": "block scalars", "%": "directives", "@": "reserved indicators",
                "`": "reserved indicators"}


class _Reader:
    """Recursive descent over the lines of one document."""

    def __init__(self, text: str, name: str):
        self.name = name
        #: [line number, indent, content] of each line with content
        self.lines: List[List] = []
        for no, raw in enumerate(text.splitlines(), 1):
            if raw.startswith(("---", "...")) and raw[3:4] in ("", " ", "\t"):
                raise self.error(no, "document markers (several documents) are outside "
                                     "the YAML subset")
            if raw.startswith("%"):
                raise self.error(no, "directives are outside the YAML subset")
            body = self._strip_comment(raw).rstrip()
            stripped = body.lstrip(" ")
            if not stripped:
                continue
            if stripped[0] == "\t" or "\t" in body[:len(body) - len(stripped)]:
                raise self.error(no, "tabs in indentation")
            self.lines.append([no, len(body) - len(stripped), stripped])
        self.i = 0

    def error(self, line: int, msg: str) -> YAMLError:
        return YAMLError(f"{self.name}:{line}: {msg}")

    @staticmethod
    def _strip_comment(raw: str) -> str:
        """The line without its comment: a '#' at the start or after
        whitespace, outside quotes. A quote opens a scalar only where one can
        start: first on the line, after ': ' or '- ', or after '[', '{', ','."""
        quote = None
        j = 0
        while j < len(raw):
            ch = raw[j]
            if quote == "'":
                if ch == "'" and raw[j + 1:j + 2] == "'":
                    j += 1  # an escaped quote
                elif ch == "'":
                    quote = None
            elif quote == '"':
                if ch == "\\":
                    j += 1
                elif ch == '"':
                    quote = None
            elif ch == "#" and (j == 0 or raw[j - 1] in " \t"):
                return raw[:j]
            elif ch in "'\"":
                before = raw[:j].rstrip(" \t")
                if (not before or before[-1] in "[{,"
                        or (before[-1] in ":-" and j > len(before))):
                    quote = ch
            j += 1
        return raw

    # --- block structure ---------------------------------------------------

    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.block(self.lines[0][1])
        if self.i < len(self.lines):
            no = self.lines[self.i][0]
            raise self.error(no, "unexpected indentation")
        return value

    def block(self, indent: int) -> Any:
        content = self.lines[self.i][2]
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        if self._split_key(content, self.lines[self.i][0]) is not None:
            return self.mapping(indent)
        no = self.lines[self.i][0]
        value = self.inline(content, no)
        self.i += 1
        if self.i < len(self.lines) and self.lines[self.i][1] > indent:
            raise self.error(self.lines[self.i][0], "multi-line scalars are outside the "
                                                    "YAML subset")
        return value

    def _split_key(self, content: str, no: int) -> Optional[Tuple[Any, str]]:
        """(key, rest) when ``content`` is a mapping entry ``key: rest``."""
        if content[0] in "'\"":
            text, end = self.quoted(content, 0, no)
            rest = content[end:]
            if rest.startswith(":") and rest[1:2] in ("", " "):
                return text, rest[1:].strip()
            return None
        if content[0] in "[{":
            return None
        j = 0
        while True:
            j = content.find(":", j)
            if j < 0:
                return None
            if content[j + 1:j + 2] in ("", " "):
                key = content[:j].rstrip()
                if key[:1] in _UNSUPPORTED or key.startswith("? "):
                    raise self.error(no, f"{_UNSUPPORTED.get(key[0], 'complex keys')} are "
                                         "outside the YAML subset")
                return resolve_plain(key, f"{self.name}:{no}"), content[j + 1:].strip()
            j += 1

    def mapping(self, indent: int) -> Dict:
        out: Dict = {}
        while self.i < len(self.lines):
            no, ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise self.error(no, "unexpected indentation")
            if content == "-" or content.startswith("- "):
                break  # a sequence at the parent's indent ends this mapping
            split = self._split_key(content, no)
            if split is None:
                raise self.error(no, f"expected 'key: value', got {content!r}")
            key, rest = split
            self.i += 1
            if rest:
                out[key] = self.inline(rest, no)
                if self.i < len(self.lines) and self.lines[self.i][1] > indent:
                    raise self.error(self.lines[self.i][0], "multi-line scalars are "
                                                            "outside the YAML subset")
            elif self.i < len(self.lines) and (
                    self.lines[self.i][1] > indent
                    or (self.lines[self.i][1] == indent
                        and (self.lines[self.i][2] == "-"
                             or self.lines[self.i][2].startswith("- ")))):
                out[key] = self.block(self.lines[self.i][1])
            else:
                out[key] = None
        return out

    def sequence(self, indent: int) -> List:
        out: List = []
        while self.i < len(self.lines):
            no, ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise self.error(no, "unexpected indentation")
            if not (content == "-" or content.startswith("- ")):
                break
            rest = content[1:].lstrip(" ")
            if not rest:
                self.i += 1
                if self.i < len(self.lines) and self.lines[self.i][1] > indent:
                    out.append(self.block(self.lines[self.i][1]))
                else:
                    out.append(None)
                continue
            # the item's content continues at its own column: read it as a
            # block from this line on
            self.lines[self.i] = [no, indent + len(content) - len(rest), rest]
            out.append(self.block(self.lines[self.i][1]))
        return out

    # --- inline values ----------------------------------------------------------

    def inline(self, text: str, no: int) -> Any:
        """A value on one line: a flow collection, a quoted or a plain scalar."""
        if text[0] in _UNSUPPORTED:
            raise self.error(no, f"{_UNSUPPORTED[text[0]]} are outside the YAML subset")
        if text[0] in "[{":
            value, end = self.flow(text, 0, no)
            if text[end:].strip():
                raise self.error(no, f"unexpected text after a flow collection: {text[end:]!r}")
            return value
        if text[0] in "'\"":
            value, end = self.quoted(text, 0, no)
            if text[end:].strip():
                raise self.error(no, f"unexpected text after a quoted scalar: {text[end:]!r}")
            return value
        if ": " in text or text.endswith(":"):
            raise self.error(no, "mapping values are not allowed here")
        return resolve_plain(text, f"{self.name}:{no}")

    def quoted(self, text: str, j: int, no: int) -> Tuple[str, int]:
        """The quoted scalar starting at text[j]: (its value, the index after it)."""
        q = text[j]
        out = []
        k = j + 1
        while k < len(text):
            ch = text[k]
            if ch == q:
                if q == "'" and text[k + 1:k + 2] == "'":
                    out.append("'")
                    k += 2
                    continue
                return "".join(out), k + 1
            if q == '"' and ch == "\\":
                esc = text[k + 1:k + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    k += 2
                    continue
                if esc in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[esc]
                    digits = text[k + 2:k + 2 + n]
                    if len(digits) != n or not all(c in "0123456789abcdefABCDEF" for c in digits):
                        raise self.error(no, f"bad escape \\{esc}{digits}")
                    out.append(chr(int(digits, 16)))
                    k += 2 + n
                    continue
                raise self.error(no, f"unknown escape \\{esc}")
            out.append(ch)
            k += 1
        raise self.error(no, "unterminated quoted scalar (multi-line scalars are outside "
                             "the YAML subset)")

    def flow(self, text: str, j: int, no: int) -> Tuple[Any, int]:
        """The flow collection or scalar starting at text[j] (spaces skipped):
        (its value, the index after it)."""
        while j < len(text) and text[j] == " ":
            j += 1
        if j >= len(text):
            raise self.error(no, "unterminated flow collection")
        ch = text[j]
        if ch in _UNSUPPORTED:
            raise self.error(no, f"{_UNSUPPORTED[ch]} are outside the YAML subset")
        if ch in "[{":
            close = "]" if ch == "[" else "}"
            items: List = []
            pairs: Dict = {}
            j += 1
            while True:
                while j < len(text) and text[j] == " ":
                    j += 1
                if j >= len(text):
                    raise self.error(no, "unterminated flow collection (multi-line flow "
                                         "collections are outside the YAML subset)")
                if text[j] == close:
                    return (items if ch == "[" else pairs), j + 1
                if text[j] == ",":
                    raise self.error(no, "empty entry in a flow collection")
                key, j = self.flow(text, j, no)
                while j < len(text) and text[j] == " ":
                    j += 1
                if ch == "{":
                    value = None
                    if text[j:j + 1] == ":":
                        value, j = self.flow(text, j + 1, no)
                    pairs[key] = value
                elif text[j:j + 1] == ":":
                    raise self.error(no, "mappings inside flow sequences are outside the "
                                         "YAML subset")
                else:
                    items.append(key)
                while j < len(text) and text[j] == " ":
                    j += 1
                if text[j:j + 1] == ",":
                    j += 1
                elif text[j:j + 1] != close:
                    raise self.error(no, f"expected ',' or {close!r} in a flow collection")
        if ch in "'\"":
            return self.quoted(text, j, no)
        k = j
        while k < len(text) and text[k] not in ",[]{}":
            if text[k] == ":" and (k + 1 == len(text) or text[k + 1] in " ,]}"):
                break
            k += 1
        return resolve_plain(text[j:k].rstrip(), f"{self.name}:{no}"), k


def parse_yaml(text: str, name: str = "<string>") -> Any:
    """One YAML document of the subset, as ``yaml.safe_load`` reads it;
    ``name`` goes into the errors."""
    return _Reader(text, name).document()


# --- configs ------------------------------------------------------------------


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml(path: str, _seen: Optional[set] = None) -> Dict:
    """Load a YAML file, flattening its ``import:`` graph (cycles refused)."""
    path = os.path.abspath(path)
    _seen = _seen or set()
    if path in _seen:
        raise ValueError(f"import cycle at {path}")
    _seen.add(path)
    with open(path) as f:
        raw = parse_yaml(f.read(), path) or {}
    if not isinstance(raw, dict):
        raise YAMLError(f"{path}: the document must be a mapping")
    merged: Dict = {}
    for imp in raw.pop("import", []) or []:
        if not os.path.isabs(imp):
            imp = os.path.join(os.path.dirname(path), imp)
        merged = _deep_merge(merged, load_yaml(imp, _seen))
    return _deep_merge(merged, raw)


def apply_overrides(cfg: Dict, overrides: Dict[str, Any]) -> Dict:
    """Apply ``{"a.b.c": v}`` dotted-key overrides to a copy of ``cfg``."""
    cfg = copy.deepcopy(cfg)
    for dotted, value in (overrides or {}).items():
        node = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg


def _resolve_refs(node: Any, root: Dict) -> Any:
    if isinstance(node, str) and node.startswith("$ref:"):
        target: Any = root
        for p in node[len("$ref:"):].split("."):
            target = target[p]
        return _resolve_refs(target, root)
    if isinstance(node, dict):
        return {k: _resolve_refs(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_refs(v, root) for v in node]
    return node


def instantiate(node: Any):
    """Recursively turn ``class:``-tagged mappings into live objects."""
    if isinstance(node, dict):
        built = {k: instantiate(v) for k, v in node.items()}
        cls_name = built.pop("class", None)
        if cls_name is not None:
            return COMPONENTS.get(cls_name)(**built)
        return built
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


class Config:
    """End to end: YAML path (+ dotted overrides) -> object graph."""

    @staticmethod
    def load(path: str, overrides: Optional[Dict[str, Any]] = None) -> Dict:
        cfg = load_yaml(path)
        cfg = apply_overrides(cfg, overrides or {})
        return _resolve_refs(cfg, cfg)

    @staticmethod
    def compile(cfg: Dict):
        return instantiate(cfg)

    @staticmethod
    def build(path: str, overrides: Optional[Dict[str, Any]] = None):
        return Config.compile(Config.load(path, overrides))


def parse_cli_overrides(argv: List[str]) -> Dict[str, Any]:
    """Trailing ``--key value`` pairs as dotted-key overrides.

    Each value is read as a YAML document (``--lr 1.0e-3`` a float, ``--hw
    '[640, 640]'`` a list, ``--validate false`` a bool); a string that Python
    reads as a float becomes one (``1e-3``, which YAML 1.1 leaves a string). A
    key with no value is True."""
    out: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"expected --key, got {tok!r}")
        key = tok[2:]
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            val = parse_yaml(argv[i + 1], f"--{key}")
            if isinstance(val, str):
                try:
                    val = float(val)
                except ValueError:
                    pass
            out[key] = val
            i += 2
        else:
            out[key] = True
            i += 1
    return out
