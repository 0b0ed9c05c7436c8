"""Param plumbing helpers (reference: util/ParamUtils.java:89)."""

from __future__ import annotations


def update_existing_params(dst, src) -> None:
    """Copy every param value from `src` to `dst` for the params `dst`
    defines (ParamUtils.updateExistingParams): estimators hand their
    shared params to the fitted model this way."""
    for param, value in src.get_param_map().items():
        dst_param = dst.get_param(param.name)
        if dst_param is not None:
            dst.set(dst_param, value)
