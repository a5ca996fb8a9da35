"""Model-family resolution shared by the decode paths and the CLI.

The port's own copy of ``distributed_llm_scheduler_tpu.parallel.decode``'s
``_family_of`` / ``_module_for`` (the port has no ``parallel/`` package):
the family of a config by its class name, and the family's model module;
and a family's seeded weights (:func:`init_params`).
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


def init_params(mod: Any, config: Any, seed: int = 0, device: Any = "cuda"):
    """A family's weights from ``seed``: drawn on the device itself where
    the family module has a seeded torch initializer (full-size Llama and
    Mixtral weights), else from its numpy initializer through the
    bridge."""
    init_torch = getattr(mod, "init_params_torch", None)
    if init_torch is not None:
        return init_torch(config, seed, device=device)
    return mod.params_from_numpy(mod.init_params_numpy(config, seed), device,
                                 config.dtype)


__all__ = ["FAMILIES", "family_of", "init_params", "module_for"]
