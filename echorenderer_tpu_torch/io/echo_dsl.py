"""The Echo description language: parse `.echo` files into scenes/profiles
(counterpart of echorenderer_tpu/io/echo_dsl.py; the objects it constructs
are this package's).

Rebuild of the reference's InOut/EchoDescription layer (EchoSource.cs,
Nodes.cs, LiteralParser.cs) as a small recursive-descent parser + an
explicit constructor registry (the reference constructs via reflection
over [EchoSourceUsable]; Python gets a table of adapters instead).

Grammar (as exercised by ext/Scenes/*.echo in the reference):

    file        := declaration*
    declaration := ':' ident '=' value
    value       := 'new' Type ctor-args? body?
                 | 'link' ident
                 | '[' value* ']'
                 | string-literal
    ctor-args   := '(' value* ')'
    body        := '{' (declaration | member)* '}'
    member      := '.' Ident '=' value          # property assignment
                 | '.' Ident '(' value* ')'     # method invocation (.Add)
    comments    := '#' to end of line

String literals are coerced by type at application time (LiteralParser
analogue): booleans, numbers, vectors ("0 6 -7"), colors ("hdr(...)",
"rgb(...)", "#aabbcc"), file paths (textures/meshes, resolved relative
to the .echo file).

Identifiers declared in a body are lexically scoped: nested bodies see
outer declarations (the reference's ScopeStack).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils.colors import parse_color

# ----------------------------------------------------------------------------
# tokenizer
# ----------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<decl>:[A-Za-z_][\w]*)
  | (?P<member>\.[A-Za-z_][\w]*)
  | (?P<word>[A-Za-z_][\w]*)
  | (?P<punct>[={}\[\]()])
  | (?P<ws>\s+)
""",
    re.VERBOSE,
)


def tokenize(text: str):
    tokens = []
    pos = 0
    line = 1
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SyntaxError(f"echo: unexpected character {text[pos]!r} at line {line}")
        kind = m.lastgroup
        val = m.group()
        line += val.count("\n")
        pos = m.end()
        if kind in ("comment", "ws"):
            continue
        tokens.append((kind, val, line))
    return tokens


# ----------------------------------------------------------------------------
# node tree
# ----------------------------------------------------------------------------


@dataclass
class TypedNode:
    type_name: str
    ctor_args: list = field(default_factory=list)
    assignments: list = field(default_factory=list)  # (prop_name, node)
    invocations: list = field(default_factory=list)  # (method_name, [nodes])
    declarations: dict = field(default_factory=dict)  # local :ids
    parent_scope: object = None


@dataclass
class LinkNode:
    target: str
    scope: object = None


@dataclass
class LiteralNode:
    text: str


@dataclass
class ArrayNode:
    items: list


class _Parser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else (None, None, -1)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def expect(self, kind, value=None):
        k, v, ln = self.next()
        if k != kind or (value is not None and v != value):
            raise SyntaxError(f"echo: expected {value or kind}, got {v!r} at line {ln}")
        return v

    def parse_file(self):
        root = TypedNode("__root__")
        while self.peek()[0] is not None:
            k, v, ln = self.peek()
            if k == "decl":
                self.next()
                self.expect("punct", "=")
                root.declarations[v[1:]] = self.parse_value(root)
            else:
                raise SyntaxError(f"echo: expected ':id =' at top level, got {v!r} line {ln}")
        return root

    def parse_value(self, scope):
        k, v, ln = self.next()
        if k == "word" and v == "new":
            _, type_name, _ = self.next()
            node = TypedNode(type_name, parent_scope=scope)
            if self.peek()[1] == "(":
                self.next()
                while self.peek()[1] != ")":
                    node.ctor_args.append(self.parse_value(node))
                self.next()
            if self.peek()[1] == "{":
                self.next()
                self.parse_body(node)
            return node
        if k == "word" and v == "link":
            _, target, _ = self.next()
            return LinkNode(target, scope)
        if k == "string":
            return LiteralNode(v[1:-1])
        if k == "punct" and v == "[":
            items = []
            while self.peek()[1] != "]":
                items.append(self.parse_value(scope))
            self.next()
            return ArrayNode(items)
        raise SyntaxError(f"echo: unexpected {v!r} at line {ln}")

    def parse_body(self, node: TypedNode):
        while True:
            k, v, ln = self.peek()
            if v == "}":
                self.next()
                return
            if k == "decl":
                self.next()
                self.expect("punct", "=")
                node.declarations[v[1:]] = self.parse_value(node)
            elif k == "member":
                self.next()
                name = v[1:]
                if self.peek()[1] == "(":
                    self.next()
                    args = []
                    while self.peek()[1] != ")":
                        args.append(self.parse_value(node))
                    self.next()
                    node.invocations.append((name, args))
                else:
                    self.expect("punct", "=")
                    node.assignments.append((name, self.parse_value(node)))
            elif k is None:
                raise SyntaxError("echo: unterminated body")
            else:
                raise SyntaxError(f"echo: unexpected {v!r} in body at line {ln}")


# ----------------------------------------------------------------------------
# literal coercion (LiteralParser.cs analogue)
# ----------------------------------------------------------------------------

_NUMBER_RE = re.compile(r"^[-+0-9.eE ]+$")


def coerce_literal(text: str):
    """Parse a string literal into bool / float / vector / color / str."""
    s = text.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low.startswith(("hdr", "rgb", "#", "0x")):
        try:
            return parse_color(s)
        except ValueError:
            pass
    if _NUMBER_RE.match(s):
        parts = s.split()
        try:
            nums = [float(p) for p in parts]
        except ValueError:
            return s
        return nums[0] if len(nums) == 1 else np.asarray(nums, np.float64)
    return s


def _pascal_to_snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


# ----------------------------------------------------------------------------
# construction: registry of adapters
# ----------------------------------------------------------------------------


class EchoSource:
    """A parsed .echo file; constructs registered objects on demand
    (reference EchoSource.ConstructFirst/Construct)."""

    def __init__(self, path_or_text, *, base_dir=None):
        p = Path(path_or_text)
        if "\n" not in str(path_or_text) and p.suffix == ".echo" and p.exists():
            # utf-8-sig: the reference ships BOM-prefixed .echo files
            text = p.read_text(encoding="utf-8-sig")
            self.base_dir = p.parent
        else:
            text = str(path_or_text)
            self.base_dir = Path(base_dir) if base_dir else Path(".")
        self.root = _Parser(tokenize(text.lstrip("\ufeff"))).parse_file()
        self._cache: dict[int, object] = {}

    # --- public API ---

    def names(self):
        return list(self.root.declarations)

    def construct(self, name: str):
        node = self.root.declarations.get(name)
        if node is None:
            raise KeyError(f"echo: no declaration :{name}")
        return self._construct(node)

    def construct_first(self, predicate):
        """First top-level object whose constructed type satisfies
        `predicate` (a class or callable)."""
        test = (lambda o: isinstance(o, predicate)) if isinstance(predicate, type) else predicate
        for name in self.root.declarations:
            obj = self.construct(name)
            if test(obj):
                return obj
        raise LookupError("echo: no matching declaration")

    # --- internals ---

    def _resolve_link(self, node: LinkNode):
        scope = node.scope
        while scope is not None:
            if node.target in scope.declarations:
                return self._construct(scope.declarations[node.target])
            scope = scope.parent_scope
        if node.target in self.root.declarations:
            return self._construct(self.root.declarations[node.target])
        raise KeyError(f"echo: unresolved link {node.target}")

    def _construct(self, node):
        if isinstance(node, LiteralNode):
            return coerce_literal(node.text)
        if isinstance(node, LinkNode):
            return self._resolve_link(node)
        if isinstance(node, ArrayNode):
            return [self._construct(i) for i in node.items]
        key = id(node)
        if key in self._cache:  # links alias the same object, like the reference
            return self._cache[key]
        from . import echo_registry

        builder = echo_registry.REGISTRY.get(node.type_name)
        if builder is None:
            raise KeyError(f"echo: unknown type {node.type_name!r}")
        args = [self._construct(a) for a in node.ctor_args]
        props = [(n, self._construct(v)) for n, v in node.assignments]
        calls = [(n, [self._construct(a) for a in aa]) for n, aa in node.invocations]
        obj = builder(self, args, props, calls)
        self._cache[key] = obj
        return obj
