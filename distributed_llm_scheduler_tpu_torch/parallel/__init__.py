"""Parallel layout: mesh axes and the parameter sharding rules.

The device-free part of the JAX package's ``parallel/``: the mesh
factorization (:mod:`.mesh`) and the tensor-parallel rule tables
(:mod:`.sharding`), which the static sharding pass
(``analysis/sharding_pass.py``) and ``lint`` read.  The strategies
themselves (ring attention, Ulysses, expert, pipeline, train, decode, the
sharded placement of params) run on ``torch.distributed`` across cards and
are not ported yet (ROADMAP.md A.11).
"""
