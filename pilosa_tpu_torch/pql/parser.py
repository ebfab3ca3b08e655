"""PQL scanner + recursive-descent parser (ref: pql/scanner.go:25-301,
pql/parser.go:28-310).

Grammar: ``Call(child(...), ..., key=value, key OP value, ...)`` —
children precede args; args are key=value where value is int, float,
string, bool, null, ident, or [list]; a comparison operator instead of
``=`` makes the value a Condition. Operators: = == != < <= > >= ><.
"""
import re

from pilosa_tpu_torch.pql.ast import Call, Condition, Query

# token types
EOF, WS, IDENT, STRING, INTEGER, FLOAT = range(6)
LPAREN, RPAREN, LBRACK, RBRACK, COMMA, ASSIGN = range(6, 12)
EQ, NEQ, LT, LTE, GT, GTE, BETWEEN = range(12, 19)

_COND_OPS = {EQ: "==", NEQ: "!=", LT: "<", LTE: "<=",
             GT: ">", GTE: ">=", BETWEEN: "><"}


class ParseError(Exception):
    def __init__(self, message, pos=None):
        self.message = message
        self.pos = pos
        super().__init__(f"{message} at {pos}" if pos is not None else message)


# One compiled master pattern instead of a per-character Python loop:
# SetBit storms parse thousands of calls per request, so scanning speed
# matters (ref: the reference's switch-based Scanner, scanner.go:60-130).
# Idents start with a letter/underscore and continue with [alnum_-];
# numbers allow one dot ("1.2.3" scans as "1.2" then errors on ".");
# strings are double-quoted with backslash-any escapes.
_TOKEN_RE = re.compile(
    r"""(?P<ws>\s+)
      | (?P<ident>[^\W\d][\w-]*)
      | (?P<number>-?\d+(?:\.\d*)?)
      | (?P<string>"(?:\\.|[^"\\])*")
      | (?P<op>==|=|!=|<=|<|>=|><|>|[()\[\],])
    """,
    re.VERBOSE | re.DOTALL,
)
_OP_TOKENS = {"==": EQ, "=": ASSIGN, "!=": NEQ, "<=": LTE, "<": LT,
              ">=": GTE, "><": BETWEEN, ">": GT, "(": LPAREN,
              ")": RPAREN, "[": LBRACK, "]": RBRACK, ",": COMMA}
_UNESCAPE_RE = re.compile(r"\\(.)", re.DOTALL)


def _scan_error(s, pos):
    if s[pos] == '"':
        return ParseError("unterminated string", pos)
    return ParseError(f"unexpected character {s[pos]!r}", pos)


def tokenize(s):
    """Return (token, pos, literal) triples (ref: scanner.go Scan)."""
    out = []
    i, n = 0, len(s)
    for m in _TOKEN_RE.finditer(s):
        if m.start() != i:
            raise _scan_error(s, i)
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        pos = m.start()
        lit = m.group()
        if kind == "ident":
            out.append((IDENT, pos, lit))
        elif kind == "number":
            out.append((FLOAT if "." in lit else INTEGER, pos, lit))
        elif kind == "string":
            out.append((STRING, pos, _UNESCAPE_RE.sub(r"\1", lit[1:-1])))
        else:
            out.append((_OP_TOKENS[lit], pos, lit))
    if i != n:
        raise _scan_error(s, i)
    out.append((EOF, n, ""))
    return out


class _Parser:
    def __init__(self, tokens):
        self.tokens = tokens
        self.i = 0

    def peek(self):
        return self.tokens[self.i]

    def next(self):
        tok = self.tokens[self.i]
        if tok[0] != EOF:
            self.i += 1
        return tok

    def expect(self, token_type, what):
        tok, pos, lit = self.next()
        if tok != token_type:
            raise ParseError(f"expected {what}, found {lit!r}", pos)
        return lit

    def parse_query(self):
        calls = []
        while self.peek()[0] != EOF:
            calls.append(self.parse_call())
        if not calls:
            raise ParseError("unexpected EOF: query required")
        return Query(calls)

    def parse_call(self):
        tok, pos, lit = self.next()
        if tok != IDENT:
            raise ParseError(f"expected identifier, found: {lit}", pos)
        name = lit
        self.expect(LPAREN, "left paren")

        children = []
        args = {}
        # Children first: IDENT followed by LPAREN (ref: parser.go:113-144).
        while (self.peek()[0] == IDENT
               and self.tokens[self.i + 1][0] == LPAREN):
            children.append(self.parse_call())
            if self.peek()[0] == COMMA:
                self.next()
            elif self.peek()[0] != RPAREN:
                tok, pos, lit = self.peek()
                raise ParseError(
                    f"expected comma or right paren, found {lit!r}", pos)

        # Key/value args.
        while self.peek()[0] != RPAREN:
            tok, pos, key = self.next()
            if tok != IDENT:
                raise ParseError(f"expected argument key, found {key!r}", pos)
            tok, pos, lit = self.next()
            if tok == ASSIGN:
                op = None
            elif tok in _COND_OPS:
                op = _COND_OPS[tok]
            else:
                raise ParseError(
                    "expected equals sign or comparison operator, "
                    f"found {lit!r}", pos)
            value = self.parse_value()
            if key in args:
                raise ParseError(f"argument key already used: {key}", pos)
            args[key] = Condition(op, value) if op else value
            if self.peek()[0] == COMMA:
                self.next()
            elif self.peek()[0] != RPAREN:
                tok, pos, lit = self.peek()
                raise ParseError(
                    f"expected comma or right paren, found {lit!r}", pos)

        self.expect(RPAREN, "right paren")
        return Call(name, args, children)

    def parse_value(self):
        tok, pos, lit = self.next()
        if tok == IDENT:
            return {"true": True, "false": False, "null": None}.get(lit, lit)
        if tok == STRING:
            return lit
        if tok == INTEGER:
            return int(lit)
        if tok == FLOAT:
            return float(lit)
        if tok == LBRACK:
            values = []
            while True:
                values.append(self.parse_value())
                tok, pos, lit = self.next()
                if tok == RBRACK:
                    return values
                if tok != COMMA:
                    raise ParseError(f"expected comma, found {lit!r}", pos)
        raise ParseError(f"invalid argument value: {lit!r}", pos)


def parse(s):
    """Parse a PQL string into a Query (ref: pql.ParseString)."""
    return _Parser(tokenize(s)).parse_query()
