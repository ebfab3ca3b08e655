"""Error catalog + name/label validation (ref: pilosa.go:27-95, 139-155)."""
import re


class PilosaError(Exception):
    """Base error; message strings match the reference catalog so HTTP
    clients see identical error text."""


def _err(msg):
    class _E(PilosaError):
        def __init__(self, m=msg):
            super().__init__(m)
    _E.__name__ = "Err" + "".join(w.capitalize() for w in re.findall(r"\w+", msg))[:40]
    return _E


ErrIndexRequired = _err("index required")
ErrIndexExists = _err("index already exists")
ErrIndexNotFound = _err("index not found")

ErrFrameRequired = _err("frame required")
ErrFrameExists = _err("frame already exists")
ErrFrameNotFound = _err("frame not found")
ErrFrameInverseDisabled = _err("frame inverse disabled")
ErrColumnRowLabelEqual = _err("column and row labels cannot be equal")

ErrFieldNotFound = _err("field not found")
ErrFieldExists = _err("field already exists")
ErrFieldNameRequired = _err("field name required")
ErrInvalidFieldType = _err("invalid field type")
ErrInvalidFieldRange = _err("invalid field range")
ErrInverseRangeNotAllowed = _err("inverse range not allowed")
ErrRangeCacheNotAllowed = _err("range cache not allowed")
ErrFrameFieldsNotAllowed = _err("frame fields not allowed")
ErrInvalidFieldValueType = _err("invalid field value type")
ErrFieldValueTooLow = _err("field value too low")
ErrFieldValueTooHigh = _err("field value too high")
ErrInvalidRangeOperation = _err("invalid range operation")
ErrInvalidBetweenValue = _err("invalid value for between operation")

ErrInvalidView = _err("invalid view")
ErrInvalidCacheType = _err("invalid cache type")

ErrName = _err("invalid index or frame's name, must match [a-z0-9_-]")
ErrLabel = _err("invalid row or column label, must match [A-Za-z0-9_-]")

ErrFragmentNotFound = _err("fragment not found")
ErrFragmentLocked = _err("fragment file locked by another process")

ErrInputDefinitionExists = _err("input-definition already exists")
ErrInputDefinitionNotFound = _err("input-definition not found")
ErrInputDefinitionHasPrimaryKey = _err(
    "input-definition must contain one PrimaryKey")
ErrInputDefinitionDupePrimaryKey = _err(
    "input-definition can only contain one PrimaryKey")
ErrInputDefinitionColumnLabel = _err(
    "PrimaryKey field name does not match columnLabel")
ErrInputDefinitionNameRequired = _err("input-definition name required")
ErrInputDefinitionAttrsRequired = _err("frames and fields are required")
ErrInputDefinitionValueMap = _err("valueMap required for map")


class ErrFragmentFailStop(PilosaError):
    """A storage fault (ENOSPC/EIO mid-append or mid-snapshot)
    fail-stopped the fragment: reads keep serving, every write is
    rejected until the fragment is reopened. The handler maps this to
    HTTP 503 — the peer should retry against a replica."""

    def __init__(self, m="fragment is read-only after a storage fault"):
        super().__init__(m)
ErrHolderLocked = _err("data directory locked by another process")
ErrQueryRequired = _err("query required")
ErrTooManyWrites = _err("too many write commands")

ErrInputDefinitionExists = _err("input-definition already exists")
ErrInputDefinitionNotFound = _err("input-definition not found")
ErrInputDefinitionHasPrimaryKey = _err("input-definition must contain one PrimaryKey")
ErrInputDefinitionDupePrimaryKey = _err("input-definition can only contain one PrimaryKey")
ErrInputDefinitionColumnLabel = _err("PrimaryKey field name does not match columnLabel")
ErrInputDefinitionNameRequired = _err("input-definition name required")
ErrInputDefinitionAttrsRequired = _err("frames and fields are required")
ErrInputDefinitionValueMap = _err("valueMap required for map")
ErrInputDefinitionActionRequired = _err("field definitions require an action")

_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,63}$")     # ref: pilosa.go:81
_LABEL_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_-]{0,63}$")  # ref: pilosa.go:84


def validate_name(name):
    if not _NAME_RE.match(name or ""):
        raise ErrName()
    return name


def validate_label(label):
    if not _LABEL_RE.match(label or ""):
        raise ErrLabel()
    return label


class DeadlineExceeded(Exception):
    """A request's deadline passed while it waited in the coalescer
    (ref: pilosa_tpu qos.DeadlineExceeded; a handler answers 504)."""

    def __init__(self, msg="deadline exceeded"):
        super().__init__(msg)


class SliceUnavailableError(Exception):
    """No live node owns a slice a query must read (ref: pilosa_tpu
    executor.py:152). Not a PilosaError: the handler's panic recovery
    answers it with 500, as the reference's does; a query never answers
    from the slices that remain."""
