"""Input definitions — stored ETL mappings from JSON records to bits
(ref: input_definition.go; counterpart of pilosa_tpu/storage/inputdef.py,
the same JSON on disk and the same errors)."""
from pilosa_tpu_torch import errors as perr

INPUT_MAPPING = "mapping"
INPUT_VALUE_TO_ROW = "value-to-row"
INPUT_SINGLE_ROW_BOOL = "single-row-boolean"
INPUT_SET_TIMESTAMP = "set-timestamp"

VALID_DESTINATIONS = (INPUT_MAPPING, INPUT_VALUE_TO_ROW,
                      INPUT_SINGLE_ROW_BOOL, INPUT_SET_TIMESTAMP)


class Action:
    """(ref: input_definition.go:204-229)."""

    def __init__(self, frame, value_destination, value_map=None, row_id=None):
        self.frame = frame
        self.value_destination = value_destination
        self.value_map = value_map or {}
        self.row_id = row_id

    def validate(self):
        if not self.frame:
            raise perr.ErrFrameRequired()
        if self.value_destination not in VALID_DESTINATIONS:
            raise ValueError(
                f"invalid ValueDestination: {self.value_destination}")
        if self.value_destination == INPUT_MAPPING and not self.value_map:
            raise perr.ErrInputDefinitionValueMap()
        return self

    def to_dict(self):
        d = {"frame": self.frame, "valueDestination": self.value_destination}
        if self.value_map:
            d["valueMap"] = self.value_map
        if self.row_id is not None:
            d["rowID"] = self.row_id
        return d

    @classmethod
    def from_dict(cls, d):
        return cls(d.get("frame", ""), d.get("valueDestination", ""),
                   d.get("valueMap"), d.get("rowID"))


def handle_action(action, value, col_id, timestamp):
    """JSON field value -> (row_id, col_id, timestamp) bit, or None
    (ref: HandleAction input_definition.go:353-390)."""
    dest = action.value_destination
    if dest == INPUT_MAPPING:
        if not isinstance(value, str):
            raise ValueError(f"Mapping value must be a string {value}")
        if value not in action.value_map:
            raise ValueError(f"Value {value} does not exist in definition map")
        return (action.value_map[value], col_id, timestamp)
    if dest == INPUT_SINGLE_ROW_BOOL:
        if not isinstance(value, bool):
            raise ValueError(
                f"single-row-boolean value {value} must equate to a Bool")
        if not value:
            return None
        return (action.row_id, col_id, timestamp)
    if dest == INPUT_VALUE_TO_ROW:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"value-to-row value must equate to an integer {value}")
        return (int(value), col_id, timestamp)
    if dest == INPUT_SET_TIMESTAMP:
        return None
    raise ValueError(f"Unrecognized Value Destination: {dest} in Action")


class InputField:
    def __init__(self, name, primary_key=False, actions=None):
        self.name = name
        self.primary_key = primary_key
        self.actions = actions or []

    def to_dict(self):
        return {"name": self.name, "primaryKey": self.primary_key,
                "actions": [a.to_dict() for a in self.actions]}

    @classmethod
    def from_dict(cls, d):
        return cls(d.get("name", ""), d.get("primaryKey", False),
                   [Action.from_dict(a) for a in d.get("actions", [])])


class InputDefinition:
    """(ref: input_definition.go:38-182)."""

    def __init__(self, name, frames, fields):
        self.name = name
        # frames: [{"name": ..., "options": {...}}]
        self.frames = frames
        self.fields = [f if isinstance(f, InputField) else InputField.from_dict(f)
                       for f in fields]

    def validate(self, column_label):
        if not self.frames or not self.fields:
            raise perr.ErrInputDefinitionAttrsRequired()
        n_primary = sum(1 for f in self.fields if f.primary_key)
        if n_primary == 0:
            raise perr.ErrInputDefinitionHasPrimaryKey()
        if n_primary > 1:
            raise perr.ErrInputDefinitionDupePrimaryKey()
        primary = next(f for f in self.fields if f.primary_key)
        if primary.name != column_label:
            raise perr.ErrInputDefinitionColumnLabel()
        for f in self.fields:
            for a in f.actions:
                a.validate()
        return self

    def to_dict(self):
        return {"frames": self.frames,
                "fields": [f.to_dict() for f in self.fields]}

    @classmethod
    def from_dict(cls, name, d):
        return cls(name, d.get("frames", []), d.get("fields", []))

    def parse_records(self, records):
        """JSON records -> {frame: [(row, col, t)]} (ref: handler.go:1948
        InputJSONDataParser + Index.InputBits)."""
        out = {}
        primary = next(f for f in self.fields if f.primary_key)
        for rec in records:
            if primary.name not in rec:
                raise ValueError(
                    f"primary key {primary.name} does not exist in record")
            col_id = rec[primary.name]
            if not isinstance(col_id, (int, float)) or isinstance(col_id, bool):
                raise ValueError("primary key must be an integer")
            col_id = int(col_id)
            timestamp = None
            for f in self.fields:
                for a in f.actions:
                    if (a.value_destination == INPUT_SET_TIMESTAMP
                            and f.name in rec):
                        timestamp = rec[f.name]
            for f in self.fields:
                if f.primary_key or f.name not in rec:
                    continue
                for a in f.actions:
                    bit = handle_action(a, rec[f.name], col_id, timestamp)
                    if bit is not None:
                        out.setdefault(a.frame, []).append(bit)
        return out
