"""Datalog text frontend: rule text -> :mod:`repro_torch.core.datalog` AST.

The paper's whole pitch is that users write *rules* --

    T1: tc(0, X, Y) :- edge(X, Y).
    T2: tc(J+1, X, Z) :- tc(J, X, Y), edge(Y, Z).
    T3: @frontier tcF(X, Y) :- tc(J, X, Y).

-- and the system derives the optimized physical plan.  This module is the
entry gate: a recursive-descent parser over a small tokenizer that lowers
text into the exact frozen-dataclass AST the stratifier
(:mod:`repro_torch.core.stratify`) and translator (:mod:`repro_torch.core.algebra`)
already pattern-match on.  Everything downstream (XY-stratification,
semi-naive rewrites, the rewrite-rule optimizer, plan notes) is shared with
hand-built programs, so parsed text and Python construction are
differentially testable against each other.

Grammar (one statement per ``.``; ``%`` starts a line comment)::

    rule      := ["@frontier"] [LABEL ":"] head ":-" body "."
    head      := IDENT "(" headterm ("," headterm)* ")"
    headterm  := term | IDENT "<" IDENT ">"          -- aggregate  agg<Var>
    body      := literal ("," literal)*
    literal   := atom
               | ("!" | "not") atom                  -- stratified negation
               | IDENT "(" term* "->" term* ")"      -- function predicate
               | operand CMP operand                 -- comparison
    atom      := IDENT "(" term ("," term)* ")"
    term      := IDENT                               -- variable (or J / J+1)
               | "_"                                 -- anonymous variable
               | NUMBER | STRING | "null" | "true" | "false"
               | "{" "(" IDENT ("," IDENT)* ")" "}"  -- set pattern {(Id, M)}
    CMP       := "==" | "!=" | "<" | "<=" | ">" | ">="

Temporal arguments follow the paper's convention: a predicate is *temporal*
iff some occurrence has ``J`` or ``J+1`` as its first argument; for temporal
predicates the first argument must then be ``0``, ``J`` or ``J+1``
(:class:`~repro_torch.core.datalog.TempZero` / ``TempVar`` / ``TempSucc``).

Head aggregates (``min<L>``, ``sum<C>``, ``topk<P>`` ...) resolve through the
:mod:`repro_torch.core.monoid` ``CombineMonoid`` registry unless an explicit
``aggregates=`` mapping overrides them.  Function predicates resolve through
the ``udfs=`` mapping (either full :class:`~repro_torch.core.datalog.UDF` records
or bare callables, whose in/out split is inferred from the call site).

The parser **fails closed**: unsafe rules (unbound head variables, variables
appearing only under negation/comparison/function inputs), unregistered
aggregates or UDFs, arity clashes, non-stratifiable or non-XY-stratifiable
programs all raise :class:`ParseError` carrying the offending
:class:`Span` -- never a silently wrong plan.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.core import stratify
from repro_torch.core.datalog import (
    Aggregate,
    AggExpr,
    Atom,
    Comparison,
    Const,
    FunctionAtom,
    Negation,
    Program,
    Rule,
    SetTerm,
    TempSucc,
    TempVar,
    TempZero,
    UDF,
    Var,
    fresh_var,
)
from repro_torch.core.monoid import MonoidError, get_monoid

__all__ = ["Span", "ParseError", "parse", "to_text"]


# ---------------------------------------------------------------------------
# Spans and errors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Span:
    """A source location: 1-based line/column plus the source line text."""

    line: int
    col: int
    end_col: int
    source_line: str = ""

    def caret(self) -> str:
        width = max(1, self.end_col - self.col)
        return " " * (self.col - 1) + "^" * width


class ParseError(Exception):
    """A frontend rejection carrying the offending source span.

    Rendered with the source line and a caret so the error is actionable::

        unsafe rule: head variable 'Z' is not bound by a positive body atom
          --> line 2, col 12
          tc(J+1, X, Z) :- tc(J, X, Y), edge(Y, Y).
                     ^
    """

    def __init__(self, message: str, span: Optional[Span] = None):
        self.message = message
        self.span = span
        super().__init__(self._render())

    def _render(self) -> str:
        if self.span is None:
            return self.message
        return (
            f"{self.message}\n"
            f"  --> line {self.span.line}, col {self.span.col}\n"
            f"  {self.span.source_line}\n"
            f"  {self.span.caret()}"
        )


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------


_TOKEN_RE = re.compile(
    r"""
      (?P<WS>[^\S\n]+)
    | (?P<COMMENT>%[^\n]*)
    | (?P<NL>\n)
    | (?P<ARROW>->)
    | (?P<IMPL>:-)
    | (?P<OP>==|!=|<=|>=|<|>)
    | (?P<NUMBER>-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)
    | (?P<IDENT>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<STRING>'(?:[^'\\\n]|\\.)*')
    | (?P<PUNCT>[(){},.:!@+])
    """,
    re.VERBOSE,
)


@dataclass(frozen=True)
class _Token:
    kind: str  # ARROW | IMPL | OP | NUMBER | IDENT | STRING | PUNCT | EOF
    text: str
    span: Span


def _tokenize(source: str) -> List[_Token]:
    lines = source.split("\n")
    tokens: List[_Token] = []
    line_no, col = 1, 1
    pos = 0
    n = len(source)
    while pos < n:
        m = _TOKEN_RE.match(source, pos)
        if m is None:
            span = Span(line_no, col, col + 1, lines[line_no - 1])
            raise ParseError(f"unexpected character {source[pos]!r}", span)
        kind = m.lastgroup or ""
        text = m.group()
        if kind == "NL":
            line_no += 1
            col = 1
        elif kind in ("WS", "COMMENT"):
            col += len(text)
        else:
            span = Span(line_no, col, col + len(text), lines[line_no - 1])
            tokens.append(_Token(kind, text, span))
            col += len(text)
        pos = m.end()
    eof_line = lines[-1] if lines else ""
    tokens.append(_Token("EOF", "", Span(line_no, col, col + 1, eof_line)))
    return tokens


# ---------------------------------------------------------------------------
# Raw (pre-resolution) syntax tree.  Terms carry their spans so that the
# second pass (temporal resolution, safety checks) can point at the exact
# offending token.
# ---------------------------------------------------------------------------


@dataclass
class _RawTerm:
    kind: str  # var | anon | number | string | null | bool | set | agg | jsucc
    value: object
    span: Span


@dataclass
class _RawAtom:
    pred: str
    args: List[_RawTerm]
    span: Span


@dataclass
class _RawFunc:
    fn: str
    ins: List[_RawTerm]
    outs: List[_RawTerm]
    span: Span


@dataclass
class _RawCmp:
    op: str
    lhs: _RawTerm
    rhs: _RawTerm
    span: Span


@dataclass
class _RawNeg:
    atom: _RawAtom
    span: Span


@dataclass
class _RawRule:
    label: str
    frontier: bool
    head: _RawAtom
    body: List[object]  # _RawAtom | _RawFunc | _RawCmp | _RawNeg
    span: Span


class _Parser:
    def __init__(self, tokens: List[_Token]):
        self.tokens = tokens
        self.pos = 0

    # -- token plumbing ----------------------------------------------------

    def peek(self, offset: int = 0) -> _Token:
        return self.tokens[min(self.pos + offset, len(self.tokens) - 1)]

    def advance(self) -> _Token:
        tok = self.tokens[self.pos]
        if tok.kind != "EOF":
            self.pos += 1
        return tok

    def at_punct(self, text: str, offset: int = 0) -> bool:
        tok = self.peek(offset)
        return tok.kind == "PUNCT" and tok.text == text

    def expect_punct(self, text: str, what: str) -> _Token:
        tok = self.peek()
        if not self.at_punct(text):
            raise ParseError(f"expected {text!r} {what}, found {tok.text!r}", tok.span)
        return self.advance()

    def expect(self, kind: str, what: str) -> _Token:
        tok = self.peek()
        if tok.kind != kind:
            raise ParseError(f"expected {what}, found {tok.text or 'end of input'!r}", tok.span)
        return self.advance()

    # -- grammar -----------------------------------------------------------

    def parse_rules(self) -> List[_RawRule]:
        rules = []
        while self.peek().kind != "EOF":
            rules.append(self.parse_rule())
        return rules

    def parse_rule(self) -> _RawRule:
        start = self.peek()
        # '@frontier' may come before or after the label.
        frontier = self.parse_annotation()
        label = ""
        if self.peek().kind == "IDENT" and self.at_punct(":", 1):
            label = self.advance().text
            self.advance()  # ':'
        frontier = self.parse_annotation() or frontier
        head = self.parse_atom(in_head=True)
        self.expect("IMPL", "':-' after rule head")
        body: List[object] = [self.parse_literal()]
        while self.at_punct(","):
            self.advance()
            body.append(self.parse_literal())
        self.expect_punct(".", "to end the rule")
        return _RawRule(label, frontier, head, body, start.span)

    def parse_annotation(self) -> bool:
        if not self.at_punct("@"):
            return False
        self.advance()
        marker = self.expect("IDENT", "'frontier' after '@'")
        if marker.text != "frontier":
            raise ParseError(
                f"unknown rule annotation @{marker.text} (only @frontier)", marker.span
            )
        return True

    def parse_literal(self) -> object:
        tok = self.peek()
        if self.at_punct("!"):
            bang = self.advance()
            atom = self.parse_atom(in_head=False)
            return _RawNeg(atom, bang.span)
        if tok.kind == "IDENT" and tok.text == "not" and self.peek(1).kind == "IDENT":
            kw = self.advance()
            atom = self.parse_atom(in_head=False)
            return _RawNeg(atom, kw.span)
        if tok.kind == "IDENT" and self.at_punct("(", 1):
            return self.parse_atom_or_func()
        # Comparison: operand CMP operand.
        lhs = self.parse_term(in_head=False, in_cmp=True)
        op = self.expect("OP", "a comparison operator")
        rhs = self.parse_term(in_head=False, in_cmp=True)
        return _RawCmp(op.text, lhs, rhs, op.span)

    def parse_atom(self, *, in_head: bool) -> _RawAtom:
        lit = self.parse_atom_or_func(in_head=in_head)
        if isinstance(lit, _RawFunc):
            raise ParseError(
                f"function predicate {lit.fn!r} not allowed here", lit.span
            )
        return lit

    def parse_atom_or_func(self, *, in_head: bool = False):
        name = self.expect("IDENT", "a predicate name")
        self.expect_punct("(", f"after predicate {name.text!r}")
        args: List[_RawTerm] = []
        arrow_at: Optional[int] = None
        if self.peek().kind == "ARROW":  # zero-input function, f(-> Out)
            arrow_at = 0
            self.advance()
        if not self.at_punct(")"):
            while True:
                args.append(self.parse_term(in_head=in_head and arrow_at is None))
                if self.at_punct(","):
                    self.advance()
                    continue
                if self.peek().kind == "ARROW":
                    if arrow_at is not None:
                        raise ParseError("duplicate '->' in function predicate",
                                         self.peek().span)
                    arrow_at = len(args)
                    self.advance()
                    if self.at_punct(")"):
                        raise ParseError("function predicate has no outputs",
                                         self.peek().span)
                    continue
                break
        self.expect_punct(")", f"to close {name.text!r}")
        if arrow_at is None:
            return _RawAtom(name.text, args, name.span)
        return _RawFunc(name.text, args[:arrow_at], args[arrow_at:], name.span)

    def parse_term(self, *, in_head: bool, in_cmp: bool = False) -> _RawTerm:
        tok = self.peek()
        if tok.kind == "NUMBER":
            self.advance()
            text = tok.text
            value = float(text) if any(c in text for c in ".eE") else int(text)
            return _RawTerm("number", value, tok.span)
        if tok.kind == "STRING":
            self.advance()
            raw = tok.text[1:-1]
            value = raw.replace("\\'", "'").replace("\\\\", "\\")
            return _RawTerm("string", value, tok.span)
        if self.at_punct("{"):
            return self.parse_set_term()
        if tok.kind != "IDENT":
            raise ParseError(f"expected a term, found {tok.text or 'end of input'!r}", tok.span)
        self.advance()
        name = tok.text
        if name == "null":
            return _RawTerm("null", None, tok.span)
        if name in ("true", "false"):
            return _RawTerm("bool", name == "true", tok.span)
        if name == "_":
            return _RawTerm("anon", None, tok.span)
        if self.at_punct("+"):  # J+1
            plus = self.advance()
            one = self.expect("NUMBER", "'1' after '+' in temporal term")
            if one.text != "1" or name != "J":
                raise ParseError("only 'J+1' is a valid temporal successor term", plus.span)
            return _RawTerm("jsucc", name, tok.span)
        if not in_cmp and self.peek().kind == "OP" and self.peek().text == "<":
            # Aggregate syntax  agg<Var>  (head positions only).
            if not in_head:
                raise ParseError(
                    f"aggregate {name}<...> is only allowed in rule heads", tok.span
                )
            self.advance()  # '<'
            var = self.expect("IDENT", f"a variable inside {name}<...>")
            close = self.peek()
            if not (close.kind == "OP" and close.text == ">"):
                raise ParseError(f"expected '>' to close {name}<...>", close.span)
            self.advance()
            return _RawTerm("agg", (name, var.text), tok.span)
        return _RawTerm("var", name, tok.span)

    def parse_set_term(self) -> _RawTerm:
        brace = self.expect_punct("{", "to open a set pattern")
        self.expect_punct("(", "after '{' in a set pattern")
        names: List[Optional[str]] = []
        while True:
            ident = self.expect("IDENT", "a variable in the set pattern")
            names.append(None if ident.text == "_" else ident.text)
            if self.at_punct(","):
                self.advance()
                continue
            break
        self.expect_punct(")", "to close the set pattern tuple")
        self.expect_punct("}", "to close the set pattern")
        return _RawTerm("set", tuple(names), brace.span)


# ---------------------------------------------------------------------------
# Resolution: raw tree -> datalog AST
# ---------------------------------------------------------------------------


def _raw_atoms(rule: _RawRule):
    """Yield every (atom, negated) occurrence in a raw rule, head included."""

    yield rule.head, False
    for lit in rule.body:
        if isinstance(lit, _RawAtom):
            yield lit, False
        elif isinstance(lit, _RawNeg):
            yield lit.atom, True


def _temporal_predicates(rules: List[_RawRule]) -> set:
    preds = set()
    for rule in rules:
        for atom, _ in _raw_atoms(rule):
            if atom.args and atom.args[0].kind in ("jsucc",) or (
                atom.args and atom.args[0].kind == "var" and atom.args[0].value == "J"
            ):
                preds.add(atom.pred)
    return preds


@dataclass
class _Builder:
    udfs: Mapping[str, object]
    aggregates: Mapping[str, Aggregate]
    temporal: set
    resolved_udfs: Dict[str, UDF] = field(default_factory=dict)
    used_aggs: Dict[str, Span] = field(default_factory=dict)

    def build_term(self, raw: _RawTerm):
        if raw.kind == "var":
            return Var(raw.value)
        if raw.kind == "anon":
            return fresh_var()
        if raw.kind in ("number", "string", "null", "bool"):
            return Const(raw.value)
        if raw.kind == "set":
            return SetTerm(tuple(Var(n) if n else fresh_var() for n in raw.value))
        if raw.kind == "agg":
            agg_name, var_name = raw.value
            self.used_aggs.setdefault(agg_name, raw.span)
            return AggExpr(agg_name, Var(var_name))
        if raw.kind == "jsucc":
            raise ParseError(
                "'J+1' may only appear as the first (temporal) argument", raw.span
            )
        raise AssertionError(raw.kind)

    def build_atom(self, raw: _RawAtom) -> Atom:
        temporal = raw.pred in self.temporal
        args: List[object] = []
        for i, term in enumerate(raw.args):
            if temporal and i == 0:
                args.append(self._temporal_term(raw, term))
            else:
                args.append(self.build_term(term))
        return Atom(raw.pred, tuple(args), temporal=temporal)

    def _temporal_term(self, raw: _RawAtom, term: _RawTerm):
        if term.kind == "jsucc":
            return TempSucc(term.value)
        if term.kind == "var" and term.value == "J":
            return TempVar("J")
        if term.kind == "number" and term.value == 0:
            return TempZero()
        raise ParseError(
            f"temporal predicate {raw.pred!r} requires 0, J, or J+1 as its "
            f"first argument",
            term.span,
        )

    def build_func(self, raw: _RawFunc) -> FunctionAtom:
        for out in raw.outs:
            if out.kind not in ("var", "anon"):
                raise ParseError(
                    f"function predicate {raw.fn!r} outputs must be variables", out.span
                )
        registered = self.udfs.get(raw.fn)
        if registered is None:
            raise ParseError(
                f"unregistered UDF {raw.fn!r} (pass it via parse(udfs=...))", raw.span
            )
        n_in, n_out = len(raw.ins), len(raw.outs)
        if isinstance(registered, UDF):
            udf = registered
        else:  # bare callable: infer the in/out split from the call site
            udf = self.resolved_udfs.get(raw.fn) or UDF(raw.fn, registered, n_in, n_out)
        if (udf.n_in, udf.n_out) != (n_in, n_out):
            raise ParseError(
                f"UDF {raw.fn!r} expects {udf.n_in} inputs and {udf.n_out} "
                f"outputs, call site has {n_in} -> {n_out}",
                raw.span,
            )
        self.resolved_udfs[raw.fn] = udf
        args = tuple(self.build_term(t) for t in raw.ins + raw.outs)
        return FunctionAtom(raw.fn, args, n_in)

    def build_cmp(self, raw: _RawCmp) -> Comparison:
        return Comparison(raw.op, self._cmp_operand(raw.lhs), self._cmp_operand(raw.rhs))

    def _cmp_operand(self, term: _RawTerm):
        if term.kind == "var":
            return Var(term.value)
        if term.kind in ("number", "string", "null", "bool"):
            return Const(term.value)
        raise ParseError("comparison operands must be variables or constants", term.span)

    def build_rule(self, raw: _RawRule) -> Rule:
        head = self.build_atom(raw.head)
        body: List[object] = []
        for lit in raw.body:
            if isinstance(lit, _RawAtom):
                body.append(self.build_atom(lit))
            elif isinstance(lit, _RawNeg):
                body.append(Negation(self.build_atom(lit.atom)))
            elif isinstance(lit, _RawFunc):
                body.append(self.build_func(lit))
            elif isinstance(lit, _RawCmp):
                body.append(self.build_cmp(lit))
            else:  # pragma: no cover - parser produces only the above
                raise AssertionError(type(lit))
        return Rule(head, tuple(body), label=raw.label, frontier=raw.frontier)


# ---------------------------------------------------------------------------
# Safety (range restriction) checks on the raw tree, where spans live
# ---------------------------------------------------------------------------


def _positive_bound_vars(rule: _RawRule) -> set:
    bound = {"J"}
    for lit in rule.body:
        if isinstance(lit, _RawAtom):
            for term in lit.args:
                if term.kind == "var":
                    bound.add(term.value)
                elif term.kind == "set":
                    bound.update(n for n in term.value if n)
        elif isinstance(lit, _RawFunc):
            bound.update(t.value for t in lit.outs if t.kind == "var")
    return bound


def _check_rule_safety(rule: _RawRule) -> None:
    bound = _positive_bound_vars(rule)
    for term in rule.head.args:
        if term.kind == "anon":
            raise ParseError(
                "anonymous variable '_' is not allowed in a rule head", term.span
            )
        names: List[Tuple[str, Span]] = []
        if term.kind == "var":
            names.append((term.value, term.span))
        elif term.kind == "agg":
            names.append((term.value[1], term.span))
        elif term.kind == "set":
            names.extend((n, term.span) for n in term.value if n)
        for name, span in names:
            if name not in bound:
                raise ParseError(
                    f"unsafe rule: head variable {name!r} is not bound by a "
                    f"positive body atom",
                    span,
                )
    for lit in rule.body:
        if isinstance(lit, _RawNeg):
            for term in lit.atom.args:
                if term.kind == "var" and term.value not in bound:
                    raise ParseError(
                        f"unsafe negation: variable {term.value!r} appears only "
                        f"under negation",
                        term.span,
                    )
        elif isinstance(lit, _RawCmp):
            for term in (lit.lhs, lit.rhs):
                if term.kind == "var" and term.value not in bound:
                    raise ParseError(
                        f"comparison over unbound variable {term.value!r}", term.span
                    )
        elif isinstance(lit, _RawFunc):
            for term in lit.ins:
                if term.kind == "var" and term.value not in bound:
                    raise ParseError(
                        f"function input variable {term.value!r} is not bound by "
                        f"a positive body atom",
                        term.span,
                    )


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _resolve_aggregates(
    used: Dict[str, Span], explicit: Mapping[str, Aggregate]
) -> Dict[str, Aggregate]:
    resolved: Dict[str, Aggregate] = {}
    for name, span in used.items():
        if name in explicit:
            resolved[name] = explicit[name]
            continue
        try:
            resolved[name] = get_monoid(name).as_aggregate()
        except MonoidError:
            raise ParseError(
                f"unregistered aggregate {name!r}: not in the CombineMonoid "
                f"registry and not passed via parse(aggregates=...)",
                span,
            ) from None
    return resolved


def _infer_edb(
    rules: List[_RawRule],
    temporal: set,
    explicit: Optional[Mapping[str, int]],
) -> Dict[str, int]:
    heads = {r.head.pred for r in rules}
    inferred: Dict[str, int] = {}
    for rule in rules:
        for atom, _ in _raw_atoms(rule):
            if atom.pred in heads:
                continue
            if atom.pred in temporal:
                raise ParseError(
                    f"temporal predicate {atom.pred!r} is never derived by any "
                    f"rule",
                    atom.span,
                )
            arity = len(atom.args)
            if inferred.setdefault(atom.pred, arity) != arity:
                raise ParseError(
                    f"EDB predicate {atom.pred!r} used with arities "
                    f"{inferred[atom.pred]} and {arity}",
                    atom.span,
                )
    if explicit:
        for name, arity in explicit.items():
            if name in heads:
                raise ParseError(
                    f"EDB predicate {name!r} is also derived by a rule head"
                )
            if inferred.get(name, arity) != arity:
                raise ParseError(
                    f"EDB predicate {name!r} declared with arity {arity} but "
                    f"used with arity {inferred[name]}"
                )
            inferred[name] = arity
    return inferred


def _first_negation_span(rules: List[_RawRule]) -> Optional[Span]:
    for rule in rules:
        for lit in rule.body:
            if isinstance(lit, _RawNeg):
                return lit.span
    return None


def _rule_span_for_message(rules: List[_RawRule], message: str) -> Optional[Span]:
    for rule in rules:
        if rule.label and re.search(rf"\b{re.escape(rule.label)}\b", message):
            return rule.span
    return None


def parse(
    text: str,
    *,
    name: str = "program",
    udfs: Optional[Mapping[str, object]] = None,
    aggregates: Optional[Mapping[str, Aggregate]] = None,
    edb: Optional[Mapping[str, int]] = None,
) -> Program:
    """Parse Datalog rule text into a validated, stratifiable Program.

    ``udfs`` maps function-predicate names to :class:`UDF` records or bare
    callables (in/out split inferred from call sites).  ``aggregates``
    overrides/extends the ``CombineMonoid`` registry for head aggregates.
    ``edb`` optionally pins extensional arities; by default every predicate
    that never appears in a rule head is inferred as EDB.

    Raises :class:`ParseError` (with the offending :class:`Span`) on syntax
    errors, unsafe rules, unregistered UDFs/aggregates, arity clashes, and
    programs that are not (XY-)stratifiable -- the frontend fails closed
    rather than handing the planner an unsound program.
    """

    raw_rules = _Parser(_tokenize(text)).parse_rules()
    if not raw_rules:
        raise ParseError("empty program: no rules found")
    for raw in raw_rules:
        _check_rule_safety(raw)
    temporal = _temporal_predicates(raw_rules)
    builder = _Builder(udfs or {}, aggregates or {}, temporal)
    rules = tuple(builder.build_rule(raw) for raw in raw_rules)
    program = Program(
        rules=rules,
        edb=_infer_edb(raw_rules, temporal, edb),
        udfs=dict(builder.resolved_udfs),
        aggregates=_resolve_aggregates(builder.used_aggs, aggregates or {}),
        name=name,
    )
    try:
        program.validate()
    except ValueError as err:
        raise ParseError(str(err), raw_rules[0].span) from None
    try:
        stratify.iteration_schedule(program)
    except stratify.StratificationError as err:
        span = _first_negation_span(raw_rules) or raw_rules[0].span
        raise ParseError(f"unstratifiable program: {err}", span) from None
    except stratify.XYError as err:
        span = _rule_span_for_message(raw_rules, str(err)) or raw_rules[0].span
        raise ParseError(f"not XY-stratified: {err}", span) from None
    return program


# ---------------------------------------------------------------------------
# Pretty-printer (the inverse: AST -> parseable text)
# ---------------------------------------------------------------------------


def _const_text(value: object) -> str:
    if value is None:
        return "null"
    if value is True:
        return "true"
    if value is False:
        return "false"
    if isinstance(value, str):
        escaped = value.replace("\\", "\\\\").replace("'", "\\'")
        return f"'{escaped}'"
    return repr(value)


def _term_text(term: object) -> str:
    if isinstance(term, TempZero):
        return "0"
    if isinstance(term, TempSucc):
        return f"{term.name}+1"
    if isinstance(term, TempVar):
        return term.name
    if isinstance(term, AggExpr):
        return f"{term.agg}<{_term_text(term.var)}>"
    if isinstance(term, SetTerm):
        return "{(" + ", ".join(_term_text(v) for v in term.elem) + ")}"
    if isinstance(term, Var):
        return "_" if "#" in term.name else term.name
    if isinstance(term, Const):
        return _const_text(term.value)
    raise TypeError(f"cannot print term {term!r}")


def _atom_text(atom: Atom) -> str:
    return f"{atom.pred}({', '.join(_term_text(t) for t in atom.args)})"


def _literal_text(lit: object) -> str:
    if isinstance(lit, Atom):
        return _atom_text(lit)
    if isinstance(lit, Negation):
        return "!" + _atom_text(lit.atom)
    if isinstance(lit, FunctionAtom):
        ins = ", ".join(_term_text(t) for t in lit.inputs)
        outs = ", ".join(_term_text(t) for t in lit.outputs)
        return f"{lit.fn}({ins} -> {outs})" if ins else f"{lit.fn}(-> {outs})"
    if isinstance(lit, Comparison):
        return f"{_term_text(lit.lhs)} {lit.op} {_term_text(lit.rhs)}"
    raise TypeError(f"cannot print body literal {lit!r}")


def _rule_text(rule: Rule) -> str:
    prefix = "@frontier " if rule.frontier else ""
    if rule.label:
        prefix += f"{rule.label}: "
    body = ", ".join(_literal_text(l) for l in rule.body)
    return f"{prefix}{_atom_text(rule.head)} :- {body}."


def to_text(program: Program) -> str:
    """Render a Program back to parseable rule text.

    Anonymous (fresh) variables print as ``_``; re-parsing therefore yields a
    program equal up to fresh-variable renaming, which is behaviorally
    identical (each ``_`` is distinct by construction).  ``to_text(parse(s))``
    is a fixpoint for programs written in this syntax.
    """

    lines = [f"% program {program.name}"]
    lines.extend(_rule_text(rule) for rule in program.rules)
    return "\n".join(lines) + "\n"
