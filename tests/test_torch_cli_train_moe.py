"""The port's ``train --model mixtral*`` (dp x ep) and ``train --pp``
(the GPT-2 pipeline) against the JAX CLI's, and every refusal of the JAX
``cmd_train`` and ``_cmd_train_moe``.

Both ``main(argv)`` run in this process: the JAX package on the first 4
of its forced host devices (``jax.devices`` patched: the MoE mesh dp1 x
ep4, ``--pp 2`` over devices 0-1), the port on 4 gloo ranks
(``DLS_PLATFORM=cpu``, ``DLS_CPU_WORLD=4``; ``--pp 2`` starts the 2 stage
ranks).  The port's runs on 4 ranks share one world: ``launch.spawn``
is patched to call ``parallel.train.run_train_loop`` there, so the file
starts two worlds, not four.  The port draws its weights and batch with numpy (the families'
``init_params_numpy``, ``parallel.train.train_batch``); the JAX CLI's
``init_params`` and ``jax.random.randint`` are patched to return the same
arrays.  The dense path trains 3 steps and saves ``--ckpt``, then resumes
and trains 2 more; the routed and pipeline paths train 2 steps and save
(a checkpoint of either loading on another mesh is
``tests/test_torch_expert_parallel.py``'s and
``tests/test_torch_pipeline_pp.py``'s).  Each ``step N: loss X`` line must agree:
the step numbers equal, the losses within the training tolerance 1e-4
plus the print's rounding (5e-5 on each side); the ``mesh dp=... x
ep=...`` note and the ``resumed from`` / ``saved`` notes equal up to the
directory's name.
"""

from __future__ import annotations

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import pytest

from distributed_llm_scheduler_tpu.__main__ import main as jmain
from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu.models import mixtral as jmixtral
from distributed_llm_scheduler_tpu_torch.__main__ import main
from distributed_llm_scheduler_tpu_torch.models import gpt2, mixtral
from distributed_llm_scheduler_tpu_torch.parallel import launch
from distributed_llm_scheduler_tpu_torch.parallel.train import train_batch

TOL = 1e-4 + 2 * 5e-5
STEP = re.compile(r"^step (\d+): loss ([0-9.]+)$")
DEVICES = 4
SEQ = ["--seq-len", "32"]
# (label, argv, steps of each run): a second run resumes the first's --ckpt
PATHS = [
    ("dense", ["--model", "mixtral-tiny"], (3, 2)),
    ("routed", ["--model", "mixtral-tiny", "--routed"], (2,)),
    ("pp", ["--model", "gpt2-tiny", "--pp", "2"], (2,)),
]


def run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _draws(mp, devices: int):
    """The JAX CLI on ``devices`` devices, with the port's draws."""
    real = jax.devices
    mp.setattr(jax, "devices", lambda *a: real(*a)[:devices])
    mp.setattr(jgpt2, "init_params", lambda c, key: {
        k: jnp.asarray(v) for k, v in gpt2.init_params_numpy(gpt2.GPT2Config(
            vocab_size=c.vocab_size, n_positions=c.n_positions, n_embd=c.n_embd,
            n_layer=c.n_layer, n_head=c.n_head), 0).items()})
    mp.setattr(jmixtral, "init_params", lambda c, key: {
        k: jnp.asarray(v) for k, v in mixtral.init_params_numpy(
            mixtral.MixtralConfig.tiny(), 0).items()})
    mp.setattr(jax.random, "randint",
               lambda key, shape, lo, hi, dtype=None: jnp.asarray(
                   train_batch(shape[0], shape[1], hi)[0]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per path and CLI: (rc, stdout, stderr with the directory named DIR)
    of each run."""
    tmp = tmp_path_factory.mktemp("train_moe")
    out = {}
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as stack:
        mp.setenv("DLS_PLATFORM", "cpu")
        mp.setenv("DLS_CPU_WORLD", str(DEVICES))
        _draws(mp, DEVICES)
        shared = launch.World(DEVICES)
        stack.callback(shared.close)
        spawn = launch.spawn

        def on_shared(fn, world, args=(), timeout=600.0):
            if world != shared.size:
                return spawn(fn, world, args, timeout)
            return shared.call(fn, args, gather=False)[0]

        mp.setattr(launch, "spawn", on_shared)
        for label, argv, steps in PATHS:
            for name, fn in (("jax", jmain), ("port", main)):
                ckpt = str(tmp / f"ckpt_{label}_{name}")
                out[label, name] = [
                    (rc, o, e.replace(ckpt, "DIR")) for rc, o, e in (
                        run(fn, ["train", *argv, *SEQ, "--steps", str(n),
                                 "--ckpt", ckpt]) for n in steps)]
    return out


def _steps(stdout):
    rows = [STEP.match(line) for line in stdout.splitlines()]
    assert all(rows), stdout
    return [(int(m.group(1)), float(m.group(2))) for m in rows]


def _notes(err):
    return [line for line in err.splitlines()
            if line.startswith(("mesh ", "resumed from", "saved "))]


@pytest.mark.parametrize("label", [p[0] for p in PATHS])
def test_train_losses_match_the_jax_cli(runs, label):
    jax_runs, port_runs = runs[label, "jax"], runs[label, "port"]
    first = 1
    for (jrc, jout, _), (prc, pout, _) in zip(jax_runs, port_runs):
        assert jrc == prc == 0
        jsteps, psteps = _steps(jout), _steps(pout)
        assert [s for s, _ in psteps] == [s for s, _ in jsteps] \
            == list(range(first, first + len(jsteps)))
        for (_, a), (_, b) in zip(psteps, jsteps):
            assert abs(a - b) <= TOL
        first += len(jsteps)
    losses = [b for _, o, _ in port_runs for _, b in _steps(o)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("label", [p[0] for p in PATHS])
def test_train_notes_match_the_jax_cli(runs, label):
    """``mesh dp=1 x ep=4, dense dispatch`` (or ``routed (capacity
    x2.0)``) first on the MoE path, ``resumed from DIR at step 3`` before
    the dense path's second run, ``saved DIR`` after each."""
    for (_, _, jerr), (_, _, perr) in zip(runs[label, "jax"], runs[label, "port"]):
        assert _notes(perr) == _notes(jerr)
    notes = _notes(runs[label, "port"][0][2])
    if label == "pp":
        assert notes == ["saved DIR"]
    else:
        assert notes[0] == ("mesh dp=1 x ep=4, dense dispatch" if label == "dense"
                            else "mesh dp=1 x ep=4, routed (capacity x2.0)")
    if label == "dense":
        assert _notes(runs[label, "port"][1][2])[1] == "resumed from DIR at step 3"
