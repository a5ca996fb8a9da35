"""Hand-written parallel strategies on ``torch.distributed``.

The JAX package runs its parallel layer SPMD from one process over a
``jax.sharding.Mesh`` and lets GSPMD insert most collectives; the port
runs one process per device (:mod:`.launch`: NCCL on the cards, gloo on
the CPU; ``spawn`` for one call, a ``World`` that lives for many, as the
compiled rung over several cards keeps one) and writes every collective
out (:mod:`.collectives`).  Ported:

* :mod:`.mesh` — ``make_mesh`` (a ``(dp, sp, tp)`` mesh of ranks with a
  process group per axis), ``make_axes_mesh`` (any named axes: ``(dp,
  ep)``, ``(pp,)``) and ``factorize_mesh``;
* :mod:`.sharding` — the rule tables, and each rank's blocks of params,
  batches and activations (``shard_params``, ``param_shardings``,
  ``batch_sharding``, ``activation_sharding``);
* :mod:`.blocks` — tensor-parallel blocks of GPT-2, Llama and Mixtral
  (dense experts) over the families' per-op functions;
* :mod:`.train` — the dp x tp (x sp) GPT-2 training step, ``TrainState``,
  ``make_eval_step`` and the ``train`` command's loop for every path;
* :mod:`.expert` — expert parallelism: stacked experts cut over ``ep``,
  dense and routed dispatch, the dp x ep Mixtral training step;
* :mod:`.pipeline_pp` — GPipe pipeline parallelism of the three families
  over ``pp`` (a stage a rank) and its training step;
* :mod:`.ring_attention`, :mod:`.ulysses` — the two sequence-parallel
  attentions;
* :mod:`.decode` — tensor-parallel ``generate_sharded``;
* :mod:`.runs` — the entry points a world runs (tests, the card checks);
* :mod:`.simworld` — a world of simulated ranks in one process, a thread
  a rank, that records every collective (the collective sweep's world).

Every module listed in :data:`COLLECTIVE_ENTRY_POINTS` exports a
``collective_probe(devices=None) -> (fn, args)`` hook: a function every
rank of a world runs, with its arguments, sized for a small mesh.
``analysis.parallel_sweep`` runs each probe on a simulated world of one
rank per device and runs the COL003/COL004 collective checks over what
the ranks issued, so ``lint --parallel`` covers the whole hand-written
parallel layer on every run.  Adding a strategy module means adding its
probe here: a missing or broken probe fails the sweep with COL008 rather
than silently shrinking coverage.
"""

#: modules under this package carrying a ``collective_probe`` hook,
#: swept by ``analysis.parallel_sweep.sweep_parallel_collectives``
COLLECTIVE_ENTRY_POINTS = (
    "ring_attention",
    "ulysses",
    "expert",
    "pipeline_pp",
    "train",
    "decode",
)
