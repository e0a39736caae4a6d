"""Composition of the experiment tree (``configs/experiment``) without pyyaml.

A copy of ``pccf/config/compose.py`` (which imports pyyaml, absent on the
machine that runs the port) with its own reader for the subset of YAML the
tree uses, held against ``yaml.safe_load`` by
``tests/test_torch_port_compose.py``:

- block mappings and block sequences (a sequence may sit at its key's
  indentation), a sequence item opening a mapping (``- model: vqvae``);
- flow sequences and flow mappings (``[8, 16]``, ``{}``), nested;
- single- and double-quoted scalars, and plain scalars resolved as YAML 1.1
  resolves them (null, booleans including ``yes``/``off``, integers,
  floats), then ``_coerce_numbers``: ``1e-04``, a string to YAML 1.1, is a
  float;
- empty values (null), ``#`` comments, and the ``# @package`` header.

Anchors, aliases, tags, block scalars and multiple documents are not in the
tree and raise :class:`ComposeError`.  On top of the reader, as in
``compose.py``: ``defaults:`` lists with group entries, relative includes
(``- ../optuna``), ``_self_`` ordering; ``${dotted.path}`` interpolation;
``key=value``, ``+key=value``, ``~key`` and ``group/sub=option`` overrides,
each value typed by the same reader (``_parse_override_value``).
"""

from __future__ import annotations

import copy
import functools
import math
import pathlib
import re
from typing import Any

_INTERP_RE = re.compile(r'\$\{([a-zA-Z0-9_.]+)\}')
_SCI_RE = re.compile(r'^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$')
# YAML 1.1's implicit resolvers, as pyyaml's resolver.py states them
_NULL_RE = re.compile(r'^(?:~|null|Null|NULL|)$')
_BOOL_RE = re.compile(r'^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$')
_INT_RE = re.compile(r'^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+'
                     r'|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$')
_FLOAT_RE = re.compile(r'^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?'
                       r'|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$')
_TRUE = ('yes', 'Yes', 'YES', 'true', 'True', 'TRUE', 'on', 'On', 'ON')


class ComposeError(RuntimeError):
    pass


# ------------------------------------------------------------------ reader


def _coerce_numbers(node: Any) -> Any:
    """YAML 1.1's stringified scientific notation (``1e-3``) to float."""
    if isinstance(node, str) and _SCI_RE.match(node):
        return float(node)
    if isinstance(node, dict):
        return {k: _coerce_numbers(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_coerce_numbers(v) for v in node]
    return node


def _sexagesimal(text: str, cast) -> Any:
    sign = -1 if text.startswith('-') else 1
    value = 0
    for part in text.lstrip('+-').split(':'):
        value = value * 60 + cast(part)
    return sign * value


def _plain(text: str) -> Any:
    """A plain scalar as YAML 1.1 resolves it."""
    if _NULL_RE.match(text):
        return None
    if _BOOL_RE.match(text):
        return text in _TRUE
    if _INT_RE.match(text):
        t = text.replace('_', '')
        sign, body = (-1, t[1:]) if t[0] == '-' else (1, t.lstrip('+'))
        if ':' in body:
            return sign * _sexagesimal(body, int)
        if body.startswith('0b'):
            return sign * int(body[2:], 2)
        if body.startswith('0x'):
            return sign * int(body[2:], 16)
        if len(body) > 1 and body.startswith('0'):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT_RE.match(text):
        t = text.replace('_', '').lower()
        if t.endswith('.inf'):
            return -math.inf if t.startswith('-') else math.inf
        if t.endswith('.nan'):
            return math.nan
        if ':' in t:
            return _sexagesimal(t, float)
        return float(t)
    return text


def _quoted(text: str, i: int) -> tuple[str, int]:
    """The quoted scalar starting at ``text[i]``, and the index past it."""
    q = text[i]
    out, j = [], i + 1
    escapes = {'n': '\n', 't': '\t', '"': '"', '\\': '\\', '/': '/', '0': '\0', 'r': '\r'}
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1: j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return ''.join(out), j + 1
        if q == '"' and c == '\\':
            nxt = text[j + 1: j + 2]
            if nxt not in escapes:
                raise ComposeError(f'unsupported escape \\{nxt} in {text!r}')
            out.append(escapes[nxt])
            j += 2
            continue
        if q == '"' and c == '"':
            return ''.join(out), j + 1
        out.append(c)
        j += 1
    raise ComposeError(f'unterminated quoted scalar in {text!r}')


def _flow(text: str, i: int, stops: str) -> tuple[Any, int]:
    """A flow node starting at ``text[i]`` (after spaces), ending before one
    of ``stops`` at nesting level 0; returns it and the index past it."""
    while i < len(text) and text[i] == ' ':
        i += 1
    if i < len(text) and text[i] in '[{':
        close = ']' if text[i] == '[' else '}'
        seq = text[i] == '['
        items: Any = [] if seq else {}
        i += 1
        while True:
            while i < len(text) and text[i] == ' ':
                i += 1
            if i >= len(text):
                raise ComposeError(f'unterminated flow collection in {text!r}')
            if text[i] == close:
                return items, i + 1
            if seq:
                node, i = _flow(text, i, ',' + close)
                items.append(node)
            else:
                key, i = _flow(text, i, ':,' + close)
                value = None
                if i < len(text) and text[i] == ':':
                    value, i = _flow(text, i + 1, ',' + close)
                items[key] = value
            while i < len(text) and text[i] == ' ':
                i += 1
            if i < len(text) and text[i] == ',':
                i += 1
    if i < len(text) and text[i] in '\'"':
        value, i = _quoted(text, i)
        return value, i
    j = i
    while j < len(text) and text[j] not in stops:
        if text[j] == ':' and ':' in stops and text[j + 1: j + 2] not in (' ', ''):
            j += 1  # a colon not followed by a space belongs to the plain scalar
            continue
        j += 1
    return _plain(text[i:j].strip()), j


def _scalar(text: str) -> Any:
    """The value text of one line: a flow collection, a quoted or a plain scalar."""
    if not text:
        return None
    if text[0] in '&*!|>%@`':
        raise ComposeError(f'unsupported YAML syntax {text!r}')
    node, end = _flow(text, 0, '')
    if text[end:].strip():
        raise ComposeError(f'trailing text after a value: {text!r}')
    return node


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a space,
    outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in '\'"' and (i == 0 or line[i - 1] in ' [{,:-'):
            quote = c
        elif c == '#' and (i == 0 or line[i - 1] in ' \t'):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str) -> tuple[str, str] | None:
    """``(key, rest)`` of a mapping entry ``key: rest`` / ``key:``, or None."""
    if text[0] in '\'"':
        key, i = _quoted(text, 0)
        rest = text[i:].lstrip(' ')
        if not rest.startswith(':'):
            return None
        return key, rest[1:].strip()
    if text[0] in '[{':
        return None
    for i, c in enumerate(text):
        if c == ':' and (i + 1 == len(text) or text[i + 1] == ' '):
            return text[:i].strip(), text[i + 1:].strip()
    return None


def _block(lines: list[tuple[int, str]], pos: int, indent: int) -> tuple[Any, int]:
    """The block node whose lines start at ``pos`` at ``indent``."""
    text = lines[pos][1]
    if text.startswith('- ') or text == '-':
        return _sequence(lines, pos, indent)
    if _split_key(text) is None:  # a scalar or flow node on a line of its own
        return _scalar(text), pos + 1
    return _mapping(lines, pos, indent)


def _value(lines, pos: int, indent: int, rest: str, seq_at_indent: bool) -> tuple[Any, int]:
    """The value after ``key:`` on line ``pos - 1``: inline, or the block
    below (a sequence may sit at the key's own indentation)."""
    if rest:
        return _scalar(rest), pos
    if pos < len(lines):
        nxt_indent, nxt = lines[pos]
        if nxt_indent > indent:
            return _block(lines, pos, nxt_indent)
        if seq_at_indent and nxt_indent == indent and (nxt.startswith('- ') or nxt == '-'):
            return _sequence(lines, pos, indent)
    return None, pos


def _mapping(lines, pos: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while pos < len(lines) and lines[pos][0] == indent:
        text = lines[pos][1]
        if text.startswith('- ') or text == '-':
            break
        entry = _split_key(text)
        if entry is None:
            raise ComposeError(f'expected "key: value", got {text!r}')
        key, rest = entry
        value, pos = _value(lines, pos + 1, indent, rest, True)
        out[_plain(key) if key and text[0] not in '\'"' else key] = value
    if pos < len(lines) and lines[pos][0] > indent:
        raise ComposeError(f'bad indentation at {lines[pos][1]!r}')
    return out, pos


def _sequence(lines, pos: int, indent: int) -> tuple[list, int]:
    out: list = []
    while pos < len(lines) and lines[pos][0] == indent and (lines[pos][1].startswith('- ') or lines[pos][1] == '-'):
        body = lines[pos][1][1:].lstrip(' ')
        inner = indent + len(lines[pos][1]) - len(body)
        if not body:
            value, pos = _value(lines, pos + 1, indent, '', False)
        elif _split_key(body) is not None:
            value, pos = _item_mapping(lines, pos + 1, inner, body)
        else:
            value, pos = _scalar(body), pos + 1
        out.append(value)
    return out, pos


def _item_mapping(lines, pos: int, inner: int, body: str) -> tuple[dict, int]:
    """The mapping a sequence item opens on line ``pos - 1``: its first entry
    ``body`` on the dash's line, the rest on the lines below at ``inner``."""
    merged = [(inner, body)]
    end = pos
    while end < len(lines) and lines[end][0] >= inner:
        merged.append(lines[end])
        end += 1
    value, used = _mapping(merged, 0, inner)
    return value, pos + used - 1


def read_yaml(text: str) -> Any:
    """``yaml.safe_load(text)`` for the tree's subset of YAML, numbers coerced."""
    lines = []
    for raw in text.splitlines():
        if '\t' in raw[: len(raw) - len(raw.lstrip())]:
            raise ComposeError('tabs in indentation')
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ('---', '...'):
            raise ComposeError('multiple documents are not supported')
        lines.append((len(line) - len(line.lstrip(' ')), line.strip()))
    if not lines:
        return None
    node, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ComposeError(f'unexpected line {lines[pos][1]!r}')
    return _coerce_numbers(node)


# ------------------------------------------------------------- composition


@functools.lru_cache(maxsize=256)
def _read_yaml_cached(path_str: str, _mtime_ns: int) -> tuple[dict[str, Any], str | None]:
    text = pathlib.Path(path_str).read_text()
    package = None
    for line in text.splitlines()[:5]:
        m = re.match(r'#\s*@package\s+(\S+)', line)
        if m:
            package = m.group(1)
            break
    data = read_yaml(text)
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ComposeError(f'{path_str}: top-level YAML must be a mapping')
    return data, package


def _read_yaml(path: pathlib.Path) -> tuple[dict[str, Any], str | None]:
    """(content, package directive), memoised on (path, mtime); a deep copy,
    since callers mutate it."""
    data, package = _read_yaml_cached(str(path), path.stat().st_mtime_ns)
    return copy.deepcopy(data), package


def _deep_merge(base: dict[str, Any], overlay: dict[str, Any]) -> dict[str, Any]:
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_path(tree: dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split('.')
    node: Any = tree
    for p in parts[:-1]:
        if isinstance(node, list) and p.lstrip('-').isdigit():
            node = node[int(p)]
            continue
        nxt = node.get(p)
        if not isinstance(nxt, (dict, list)):
            nxt = {}
            node[p] = nxt
        node = nxt
    last = parts[-1]
    if isinstance(node, list) and last.lstrip('-').isdigit():
        node[int(last)] = value
    else:
        node[last] = value


def _get_path(tree: Any, dotted: str) -> Any:
    node = tree
    for p in dotted.split('.'):
        if isinstance(node, dict):
            if p not in node:
                raise KeyError(dotted)
            node = node[p]
        elif isinstance(node, (list, tuple)) and p.lstrip('-').isdigit():
            node = node[int(p)]
        else:
            raise KeyError(dotted)
    return node


def _del_path(tree: dict[str, Any], dotted: str) -> None:
    parts = dotted.split('.')
    node = tree
    for p in parts[:-1]:
        node = node[p]
    del node[parts[-1]]


def _compose_file(path: pathlib.Path, groups: dict[str, str], used: set[str] | None = None) -> dict[str, Any]:
    """A YAML file with its defaults list resolved; ``groups`` maps group
    paths relative to this file to the selected option, and the group keys
    a defaults entry consumes are added to ``used``."""
    used = set() if used is None else used
    data, _package = _read_yaml(path)
    defaults = data.pop('defaults', None)
    own = data
    if defaults is None:
        return own
    merged: dict[str, Any] = {}
    self_done = False
    for entry in defaults:
        if entry == '_self_':
            merged = _deep_merge(merged, own)
            self_done = True
            continue
        if isinstance(entry, str):
            # a relative include (../optuna); a name with no file is a no-op
            candidate = (path.parent / f'{entry}.yaml').resolve()
            if candidate.exists():
                merged = _deep_merge(merged, _compose_file(candidate, {}))
            continue
        if isinstance(entry, dict):
            [(group, name)] = entry.items()
            if group in groups:
                name = groups[group]
                used.add(group)
            if name is None:
                continue
            sub_path = path.parent / group / f'{name}.yaml'
            if not sub_path.exists():
                raise ComposeError(f'{path}: missing config group file {sub_path}')
            nested = {g.split('/', 1)[1]: n for g, n in groups.items() if g.startswith(f'{group}/')}
            nested_used: set[str] = set()
            sub = _compose_file(sub_path, nested, nested_used)
            used.update(f'{group}/{u}' for u in nested_used)
            _, sub_package = _read_yaml(sub_path)
            if sub_package == '_global_':
                merged = _deep_merge(merged, sub)
            elif sub_package and sub_package != '_group_':
                placed: dict[str, Any] = {}
                _set_path(placed, sub_package, sub)
                merged = _deep_merge(merged, placed)
            else:
                merged = _deep_merge(merged, {group.split('/')[-1]: sub})
            continue
        raise ComposeError(f'{path}: bad defaults entry {entry!r}')
    if not self_done:
        merged = _deep_merge(merged, own)
    return merged


def _resolve_interpolations(tree: dict[str, Any]) -> dict[str, Any]:
    """``${a.b.c}`` references, chains included, against the root tree; a
    whole-value reference keeps the referent's type."""

    def resolve(node: Any, depth: int = 0) -> Any:
        if depth > 20:
            raise ComposeError('interpolation depth exceeded (cycle?)')
        if isinstance(node, str):
            m = _INTERP_RE.fullmatch(node)
            if m:
                return resolve(_get_path(tree, m.group(1)), depth + 1)
            return _INTERP_RE.sub(lambda mm: str(resolve(_get_path(tree, mm.group(1)), depth + 1)), node)
        if isinstance(node, dict):
            return {k: resolve(v, depth) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v, depth) for v in node]
        return node

    for _ in range(10):
        new = resolve(tree)
        if new == tree:
            return new
        tree = new
    return tree


def _parse_override_value(raw: str) -> Any:
    """An override's value typed by the reader; text it cannot read stays text."""
    try:
        return read_yaml(raw)
    except ComposeError:
        return raw


def apply_overrides(tree: dict[str, Any], overrides: list[str]) -> dict[str, Any]:
    """Dotted overrides on a composed tree: ``a.b=v`` must name an existing
    key, ``+a.b=v`` adds one, ``~a.b`` deletes one."""
    tree = copy.deepcopy(tree)
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        if ov.startswith('~'):
            key = ov[1:].split('=', 1)[0]
            try:
                _del_path(tree, key)
            except KeyError:
                raise ComposeError(f'deletion override key {key!r} does not exist in the composed config') from None
            continue
        additive = ov.startswith('+')
        if additive:
            ov = ov[1:]
        if '=' not in ov:
            raise ComposeError(f'override {ov!r} must be key=value')
        key, raw = ov.split('=', 1)
        if not additive:
            try:
                _get_path(tree, key)
            except KeyError:
                raise ComposeError(f"override key {key!r} does not exist in the composed config; prefix with '+' "
                                   f'to add a new key') from None
        _set_path(tree, key, _parse_override_value(raw))
    return tree


def split_overrides(overrides: list[str]) -> tuple[dict[str, str], list[str]]:
    """Group selections (a ``/`` in the key) apart from value overrides."""
    groups: dict[str, str] = {}
    values: list[str] = []
    for ov in overrides:
        key = ov.split('=', 1)[0]
        if '=' in ov and '/' in key and not ov.startswith(('+', '~')):
            groups[key] = ov.split('=', 1)[1]
        else:
            values.append(ov)
    return groups, values


def compose(config_path: str | pathlib.Path, config_name: str = 'defaults', overrides: list[str] | None = None,
            group_overrides: dict[str, str] | None = None) -> dict[str, Any]:
    """The tree rooted at ``config_path/config_name.yaml`` with its defaults,
    the overrides and the interpolations applied (``compose.py:279-320``)."""
    root_dir = pathlib.Path(config_path)
    root_file = root_dir / f'{config_name}.yaml'
    if not root_file.exists():
        raise ComposeError(f'config root {root_file} not found')
    groups, value_overrides = split_overrides(list(overrides or []))
    remaining = []
    for ov in value_overrides:
        # a plain key naming a group directory selects an option (tune=learn)
        key = ov.split('=', 1)[0].lstrip('+~')
        if '=' in ov and '.' not in key and (root_dir / key).is_dir():
            groups[key] = ov.split('=', 1)[1]
        else:
            remaining.append(ov)
    groups = {**groups, **(group_overrides or {})}
    used: set[str] = set()
    tree = _compose_file(root_file, groups, used)
    unknown = sorted(set(groups) - used)
    if unknown:
        raise ComposeError(f'unknown config group selection(s) {unknown}: no defaults entry matches (check for '
                           f'typos, e.g. data/datset vs data/dataset)')
    tree = apply_overrides(tree, remaining)
    return _resolve_interpolations(tree)
