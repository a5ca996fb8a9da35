"""Mesh axis conventions and their factorization.

PyTorch port of the device-free part of ``distributed_llm_scheduler_tpu.
parallel.mesh``:

* ``dp``  — data parallel (batch dimension; gradients all-reduced)
* ``tp``  — tensor parallel (Megatron-style sharded matmuls; activations
  all-reduced inside each layer)
* ``sp``  — sequence/context parallel (ring attention over sequence chunks)

:func:`factorize_mesh` is a copy of the JAX package's.  Building a mesh
over live cards (``make_mesh``) and the ``NamedSharding`` helpers come with
the parallel layer on ``torch.distributed`` (ROADMAP.md A.11).
"""

from __future__ import annotations

from typing import Dict


def factorize_mesh(n_devices: int, prefer_tp: int = 4) -> Dict[str, int]:
    """Pick a reasonable (dp, tp) split for n devices: tp = the largest
    power-of-two divisor of n up to ``prefer_tp``, dp = the rest."""
    tp = 1
    while tp * 2 <= prefer_tp and n_devices % (tp * 2) == 0:
        tp *= 2
    return {"dp": n_devices // tp, "tp": tp, "sp": 1}


__all__ = ["factorize_mesh"]
