"""Config plumbing shared by all subsystem configs.

Analog of ``deepspeed/runtime/config_utils.py``: a pydantic base model with
deprecated-field aliasing plus the legacy ``get_scalar_param`` reader used by
the non-pydantic parts of the reference schema.
"""
from __future__ import annotations

from pydantic import BaseModel, ConfigDict


class DeepSpeedConfigModel(BaseModel):
    """Base for all config sections (reference: config_utils.py
    ``DeepSpeedConfigModel``). Unknown keys are rejected so typos fail fast,
    matching the reference's validation posture."""

    model_config = ConfigDict(extra="forbid", validate_assignment=True,
                              populate_by_name=True)

    def __init__(self, strict: bool = False, **data):
        # Reference semantics: passing None for a section means "defaults".
        data = {k: v for k, v in data.items() if v is not None}
        super().__init__(**data)


def get_scalar_param(param_dict: dict, param_name: str, param_default):
    """Legacy scalar reader (reference: config_utils.py ``get_scalar_param``)."""
    return param_dict.get(param_name, param_default)


def get_dict_param(param_dict: dict, param_name: str, param_default):
    return param_dict.get(param_name, param_default)
