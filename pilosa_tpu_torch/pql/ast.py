"""PQL AST (ref: pql/ast.go)."""

WRITE_CALLS = ("SetBit", "ClearBit", "SetRowAttrs", "SetColumnAttrs",
               "SetFieldValue")


class Query:
    def __init__(self, calls=None):
        self.calls = calls or []

    def write_call_n(self):
        """Number of mutating calls (ref: ast.go:32-41; SetFieldValue is
        counted by the executor's MaxWritesPerRequest check)."""
        return sum(1 for c in self.calls if c.name in WRITE_CALLS)

    def __str__(self):
        return "\n".join(str(c) for c in self.calls)

    def __repr__(self):
        return f"Query({self.calls!r})"


class Condition:
    """op + value, e.g. ``field > 5`` (ref: ast.go:220-253)."""

    def __init__(self, op, value):
        self.op = op          # one of "==", "!=", "<", "<=", ">", ">=", "><"
        self.value = value

    def int_slice_value(self):
        if not isinstance(self.value, list):
            raise ValueError(
                f"unexpected type {type(self.value).__name__} in IntSliceValue")
        return [int(v) for v in self.value]

    def __str__(self):
        return f"{self.op} {format_value(self.value)}"

    def __repr__(self):
        return f"Condition({self.op!r}, {self.value!r})"

    def __eq__(self, other):
        return (isinstance(other, Condition) and self.op == other.op
                and self.value == other.value)


class Call:
    def __init__(self, name, args=None, children=None):
        self.name = name
        self.args = args or {}
        self.children = children or []

    def uint_arg(self, key):
        """(value, ok) (ref: ast.go:60-76); raises on non-int or
        negative.

        Deliberate deviation: the reference casts int64→uint64, so a
        negative id silently wraps to ~2^64 and poisons MaxSlice (the
        next read would fan out over trillions of slices — same bomb
        there). We reject negatives with the conversion error the
        reference reserves for unconvertible types."""
        if key not in self.args:
            return 0, False
        val = self.args[key]
        if isinstance(val, bool) or not isinstance(val, int) or val < 0:
            raise ValueError(
                f"could not convert {val} of type {type(val).__name__} "
                "to uint64 in Call.UintArg")
        return val, True

    def uint_slice_arg(self, key):
        if key not in self.args:
            return None, False
        val = self.args[key]
        if not isinstance(val, list):
            raise ValueError(f"unexpected type in UintSliceArg, val {val}")
        return [int(v) for v in val], True

    def keys(self):
        return sorted(self.args)

    def clone(self):
        return Call(self.name, dict(self.args),
                    [c.clone() for c in self.children])

    def supports_inverse(self):
        """(ref: ast.go:181-184)."""
        return self.name in ("Bitmap", "TopN")

    def is_inverse(self, row_label, column_label):
        """Row-vs-column arg orientation (ref: ast.go:186-207)."""
        if not self.supports_inverse():
            return False
        if self.name == "TopN":
            return self.args.get("inverse") is True
        try:
            _, row_ok = self.uint_arg(row_label)
            _, col_ok = self.uint_arg(column_label)
        except ValueError:
            return False
        return (not row_ok) and col_ok

    def has_condition_arg(self):
        return any(isinstance(v, Condition) for v in self.args.values())

    def __str__(self):
        parts = [str(c) for c in self.children]
        for key in self.keys():
            v = self.args[key]
            if isinstance(v, Condition):
                parts.append(f"{key} {v}")
            else:
                parts.append(f"{key}={format_value(v)}")
        return f"{self.name}({', '.join(parts)})"

    def __repr__(self):
        return f"Call({self.name!r}, {self.args!r}, {self.children!r})"

    def __eq__(self, other):
        return (isinstance(other, Call) and self.name == other.name
                and self.args == other.args and self.children == other.children)


def format_value(v):
    """(ref: ast.go FormatValue)."""
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, list):
        return "[" + ",".join(format_value(x) for x in v) + "]"
    return str(v)
