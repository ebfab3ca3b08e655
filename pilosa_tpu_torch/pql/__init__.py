"""PQL — the Pilosa Query Language (ref: pql/).

``Call(child1(...), child2(...), key=value, field > 5)`` form: children
are nested calls, args are key=value pairs or conditions
(``= == != < <= > >= ><``).
"""
from pilosa_tpu_torch.pql.ast import Call, Condition, Query  # noqa: F401
from pilosa_tpu_torch.pql.parser import ParseError, parse  # noqa: F401
