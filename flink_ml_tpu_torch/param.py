"""Typed, validated, JSON-serializable hyperparameters.

Port of flink_ml_tpu/param.py (the reference's param/Param.java,
WithParams.java, ParamValidators.java). Params are class attributes on
mixins and are discovered by walking the MRO. The JSON encoding keeps the
reference's camelCase names and value encodings, so a `paramMap` written
by either package decodes in the other.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generic, List, Optional, Sequence, TypeVar

T = TypeVar("T")


class ParamValidator(Generic[T]):
    """Validates a parameter value (param/ParamValidator.java)."""

    def __init__(self, fn: Callable[[Any], bool], description: str = ""):
        self._fn = fn
        self.description = description

    def validate(self, value: Any) -> bool:
        try:
            return bool(self._fn(value))
        except TypeError:
            return False

    def __call__(self, value: Any) -> bool:
        return self.validate(value)


class ParamValidators:
    """Factory of common validators (param/ParamValidators.java)."""

    @staticmethod
    def always_true() -> ParamValidator:
        return ParamValidator(lambda v: True, "always true")

    @staticmethod
    def gt(lower) -> ParamValidator:
        return ParamValidator(lambda v: v is not None and v > lower, f"> {lower}")

    @staticmethod
    def gt_eq(lower) -> ParamValidator:
        return ParamValidator(lambda v: v is not None and v >= lower, f">= {lower}")

    @staticmethod
    def lt(upper) -> ParamValidator:
        return ParamValidator(lambda v: v is not None and v < upper, f"< {upper}")

    @staticmethod
    def lt_eq(upper) -> ParamValidator:
        return ParamValidator(lambda v: v is not None and v <= upper, f"<= {upper}")

    @staticmethod
    def in_range(lower, upper, lower_inclusive=True, upper_inclusive=True) -> ParamValidator:
        def check(v):
            if v is None:
                return False
            lo_ok = v >= lower if lower_inclusive else v > lower
            hi_ok = v <= upper if upper_inclusive else v < upper
            return lo_ok and hi_ok

        return ParamValidator(check, f"in range {lower}..{upper}")

    @staticmethod
    def in_array(allowed: Sequence) -> ParamValidator:
        allowed = list(allowed)
        return ParamValidator(lambda v: v in allowed, f"in {allowed}")

    @staticmethod
    def not_null() -> ParamValidator:
        return ParamValidator(lambda v: v is not None, "not null")

    @staticmethod
    def non_empty_array() -> ParamValidator:
        return ParamValidator(lambda v: v is not None and len(v) > 0, "non-empty array")

    @staticmethod
    def is_sub_set(allowed: Sequence) -> ParamValidator:
        allowed_set = set(allowed)
        return ParamValidator(
            lambda v: v is not None and set(v).issubset(allowed_set),
            f"subset of {sorted(allowed_set)}",
        )


class Param(Generic[T]):
    """A parameter: name, description, default value, validator
    (param/Param.java). Equal by name, so re-declarations compare equal."""

    def __init__(
        self,
        name: str,
        description: str,
        default_value: Optional[T],
        validator: Optional[ParamValidator[T]] = None,
    ):
        self.name = name
        self.description = description
        self.default_value = default_value
        self.validator = validator or ParamValidators.always_true()
        if default_value is not None and not self.validator.validate(default_value):
            raise ValueError(f"Parameter {name} is given an invalid value {default_value}")

    def json_encode(self, value: T) -> Any:
        return value

    def json_decode(self, json_value: Any) -> T:
        return json_value

    def validate(self, value: Any) -> None:
        if not self.validator.validate(value):
            raise ValueError(f"Parameter {self.name} is given an invalid value {value}")

    def __eq__(self, other):
        return isinstance(other, Param) and other.name == self.name

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"Param<{self.name}>"


class BooleanParam(Param[bool]):
    def json_decode(self, json_value):
        return None if json_value is None else bool(json_value)


class IntParam(Param[int]):
    def json_decode(self, json_value):
        return None if json_value is None else int(json_value)


class LongParam(IntParam):
    pass


class FloatParam(Param[float]):
    def json_decode(self, json_value):
        return None if json_value is None else float(json_value)


class DoubleParam(FloatParam):
    pass


class StringParam(Param[str]):
    pass


class _ArrayParam(Param[List]):
    """A list-valued param, JSON-encoded as a list of its element type."""

    _elem = staticmethod(lambda v: v)

    def json_encode(self, value):
        return None if value is None else list(value)

    def json_decode(self, json_value):
        if json_value is None:
            return None
        return [self._elem(v) for v in json_value]


class IntArrayParam(_ArrayParam):
    _elem = staticmethod(int)


class LongArrayParam(IntArrayParam):
    pass


class FloatArrayParam(_ArrayParam):
    _elem = staticmethod(float)


class DoubleArrayParam(FloatArrayParam):
    pass


class StringArrayParam(_ArrayParam):
    _elem = staticmethod(str)


class DoubleArrayArrayParam(Param[List[List[float]]]):
    """A list of float lists, e.g. one array of split points per column."""

    def json_encode(self, value):
        return None if value is None else [list(map(float, row)) for row in value]

    def json_decode(self, json_value):
        if json_value is None:
            return None
        return [[float(v) for v in row] for row in json_value]


class VectorParam(Param):
    """A DenseVector or SparseVector value (param/VectorParam.java), JSON
    as {"type": "dense", "values": [...]} or {"type": "sparse", "size",
    "indices", "values"}; a JSON object without a type is dense."""

    def json_encode(self, value):
        if value is None:
            return None
        from .linalg import DenseVector, SparseVector

        if isinstance(value, SparseVector):
            return {
                "type": "sparse",
                "size": int(value.size()),
                "indices": [int(i) for i in value.indices],
                "values": [float(v) for v in value.values],
            }
        if isinstance(value, DenseVector):
            return {"type": "dense", "values": [float(v) for v in value.values]}
        raise TypeError(f"Unsupported vector value {value!r}")

    def json_decode(self, json_value):
        if json_value is None:
            return None
        from .linalg import Vectors

        if json_value.get("type") == "sparse":
            return Vectors.sparse(json_value["size"], json_value["indices"], json_value["values"])
        return Vectors.dense(*json_value["values"])


class WindowsParam(Param):
    """A window descriptor (param/WindowsParam.java), JSON as the
    descriptor's own encoding (common/window.py)."""

    def json_encode(self, value):
        if value is None:
            return None
        return value.json_encode()

    def json_decode(self, json_value):
        if json_value is None:
            return None
        from .common.window import Windows

        return Windows.json_decode(json_value)


class WithParams:
    """Mixin giving get/set access to params declared as class attributes
    (param/WithParams.java)."""

    _param_map: Dict[Param, Any]

    def _ensure_params(self) -> Dict[Param, Any]:
        if "_param_map" not in self.__dict__:
            self.__dict__["_param_map"] = {
                p: p.default_value for p in _discover_params(type(self))
            }
        return self.__dict__["_param_map"]

    def get_param(self, name: str) -> Optional[Param]:
        for p in self._ensure_params():
            if p.name == name:
                return p
        return None

    def set(self, param: Param, value) -> "WithParams":
        params = self._ensure_params()
        if param not in params:
            raise ValueError(f"Parameter {param.name} is not defined on {type(self).__name__}")
        if value is not None:
            param.validate(value)
        params[param] = value
        # a monotone token for the fusion planner's plan cache and the
        # device-constant cache (api.AlgoOperator.device_constants): a
        # param change invalidates captured transforms that baked the old value
        self.__dict__["_params_version"] = self.__dict__.get("_params_version", 0) + 1
        return self

    def get(self, param: Param):
        params = self._ensure_params()
        if param not in params:
            raise ValueError(f"Parameter {param.name} is not defined on {type(self).__name__}")
        value = params[param]
        if value is None and param.default_value is not None:
            return param.default_value
        return value

    def get_param_map(self) -> Dict[Param, Any]:
        return self._ensure_params()


def _discover_params(cls) -> List[Param]:
    seen: Dict[str, Param] = {}
    for klass in cls.__mro__:
        for attr in vars(klass).values():
            if isinstance(attr, Param) and attr.name not in seen:
                seen[attr.name] = attr
    return list(seen.values())
