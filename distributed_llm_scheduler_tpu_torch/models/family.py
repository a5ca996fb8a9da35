"""Model-family resolution shared by the decode paths.

The port's own copy of ``distributed_llm_scheduler_tpu.parallel.decode``'s
``_family_of`` / ``_module_for`` (the port has no ``parallel/`` package):
the family of a config by its class name, and the family's model module.
"""

from __future__ import annotations

from typing import Any

FAMILIES = ("gpt2", "llama", "mixtral")


def family_of(config: Any) -> str:
    """``"gpt2"``, ``"llama"`` or ``"mixtral"`` from the config's class name."""
    name = type(config).__name__.lower()
    for fam in FAMILIES:
        if fam in name:
            return fam
    raise ValueError(f"unknown model family for config {type(config)!r}")


def module_for(family: str):
    """The family's model module (``models.gpt2``, ``.llama``, ``.mixtral``)."""
    from . import gpt2, llama, mixtral

    return {"gpt2": gpt2, "llama": llama, "mixtral": mixtral}[family]


__all__ = ["FAMILIES", "family_of", "module_for"]
