"""Import reference-format pickled DAG artifacts.

The reference persists its extracted GPT-2 DAG as a pickled
``List[schedulers.Task]`` (reference ``test_gpt2.py:266-269`` writes
``gpt2_dag.pkl``).  Our own serialization is JSON
(:mod:`..utils.serialization`) — strictly better for interchange — but a
user migrating from the reference may hold ``.pkl`` artifacts whose
producing module no longer exists on their path.  This loader reads them
*without* the reference code installed: a restricted unpickler maps the
reference's ``Task``/``Node`` globals onto attribute-bag shims and refuses
everything else (pickle is code execution; an allowlist is the only safe
way to open third-party pickles).

Converted tasks keep the reference's semantics: per-param sizes are not in
the artifact (the reference hardcodes 0.5 GB/param, reference
``schedulers.py:70,89``), so the resulting graph uses our default param
size, which is the same 0.5 GB.

PyTorch port's copy of ``distributed_llm_scheduler_tpu.frontend.
reference_import``, whole: the module is framework-free, and it reads the
same artifacts into the same graphs and refuses the same globals.
"""

from __future__ import annotations

import io
import pickle
from collections import deque
from typing import Any, List, Union

from ..core.graph import Task, TaskGraph

# (module, qualname) globals a reference artifact may legitimately contain.
_SHIM_CLASSES = {
    ("schedulers", "Task"),
    ("schedulers", "Node"),
    ("test_gpt2", "Task"),
    ("visu", "Task"),
    ("visu", "Node"),
    ("__main__", "Task"),
    ("__main__", "Node"),
}
_SAFE_GLOBALS = {
    ("collections", "deque"): deque,
    ("builtins", "set"): set,
    ("builtins", "frozenset"): frozenset,
    ("builtins", "list"): list,
    ("builtins", "dict"): dict,
}


class _Shim:
    """Attribute bag standing in for the reference's mutable classes."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        pass  # reference pickles carry state in __dict__, not ctor args


class _RefUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _SHIM_CLASSES:
            return _Shim
        if (module, name) in _SAFE_GLOBALS:
            return _SAFE_GLOBALS[(module, name)]
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name}: reference DAG artifacts "
            f"contain only Task/Node objects and builtin containers"
        )


def load_reference_pickle(source: Union[str, bytes, io.IOBase]) -> TaskGraph:
    """Reference ``gpt2_dag.pkl``-style artifact -> :class:`TaskGraph`.

    Accepts a path, raw bytes, or a binary file object.  The artifact must
    be a list of reference ``Task`` objects (``id``, ``memory_required``,
    ``compute_time``, ``dependencies``, ``params_needed`` — reference
    ``schedulers.py:7-17``); scheduling state (``completed``,
    ``assigned_node``) is discarded, as a fresh schedule recomputes it.
    """
    if isinstance(source, (str,)):
        with open(source, "rb") as f:
            data = f.read()
    elif isinstance(source, bytes):
        data = source
    else:
        data = source.read()
    obj = _RefUnpickler(io.BytesIO(data)).load()
    if not isinstance(obj, list):
        raise ValueError(
            f"expected a pickled list of reference Tasks, got {type(obj).__name__}"
        )
    tasks: List[Task] = []
    for i, rt in enumerate(obj):
        d = getattr(rt, "__dict__", None)
        if d is None or "id" not in d:
            raise ValueError(f"artifact entry {i} is not a reference Task")
        tasks.append(
            Task(
                task_id=str(d["id"]),
                memory_required=float(d.get("memory_required", 0.0)),
                compute_time=float(d.get("compute_time", 0.0)),
                dependencies=[str(x) for x in d.get("dependencies", [])],
                params_needed=set(d.get("params_needed", ()) or ()),
            )
        )
    return TaskGraph(tasks, name="reference_import").freeze()
