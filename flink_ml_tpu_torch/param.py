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


class IntParam(Param[int]):
    def json_decode(self, json_value):
        return None if json_value is None else int(json_value)


class FloatParam(Param[float]):
    def json_decode(self, json_value):
        return None if json_value is None else float(json_value)


class StringParam(Param[str]):
    pass


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
