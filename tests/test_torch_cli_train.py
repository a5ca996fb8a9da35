"""The port's ``train`` command against the JAX CLI's.

Both ``main(argv)`` run in this process on ``gpt2-tiny``: the JAX package
on its 8 forced host devices (``factorize_mesh(8)``: dp2 x tp4, batch 4),
the port on 8 gloo ranks (``DLS_PLATFORM=cpu``, ``DLS_CPU_WORLD=8``, the
same mesh).  The port draws its weights and batch with numpy
(``gpt2.init_params_numpy``, ``parallel.train.train_batch``); the JAX
CLI's ``init_params`` and ``jax.random.randint`` are patched to return
the same arrays, so both train the same model on the same tokens.  A
first run trains 3 steps and saves ``--ckpt``; a second resumes from it
and trains 2 more.  Each ``step N: loss X`` line must agree: the step
numbers equal, the losses within the training tolerance 1e-4 plus the
print's rounding to 4 decimals (5e-5 on each side); the stderr notes
(``resumed from``, ``saved``) equal up to the directory's name.
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
from distributed_llm_scheduler_tpu_torch.__main__ import main
from distributed_llm_scheduler_tpu_torch.models import gpt2
from distributed_llm_scheduler_tpu_torch.parallel.train import train_batch

TOL = 1e-4 + 2 * 5e-5
STEP = re.compile(r"^step (\d+): loss ([0-9.]+)$")


def run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _port_config(c):
    return gpt2.GPT2Config(vocab_size=c.vocab_size, n_positions=c.n_positions,
                           n_embd=c.n_embd, n_layer=c.n_layer, n_head=c.n_head)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rc, stdout, stderr with the directory named DIR) of the two runs
    of each CLI."""
    tmp = tmp_path_factory.mktemp("train")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLS_PLATFORM", "cpu")
        mp.setenv("DLS_CPU_WORLD", "8")
        mp.setattr(jgpt2, "init_params", lambda config, key: {
            k: jnp.asarray(v) for k, v in
            gpt2.init_params_numpy(_port_config(config), 0).items()})
        mp.setattr(jax.random, "randint",
                   lambda key, shape, lo, hi, dtype=None: jnp.asarray(
                       train_batch(shape[0], shape[1], hi)[0]))
        for name, fn in (("jax", jmain), ("port", main)):
            ckpt = str(tmp / f"ckpt_{name}")
            first = run(fn, ["train", "--model", "gpt2-tiny", "--steps", "3",
                             "--ckpt", ckpt])
            second = run(fn, ["train", "--model", "gpt2-tiny", "--steps", "2",
                              "--ckpt", ckpt])
            out[name] = [(rc, o, e.replace(ckpt, "DIR")) for rc, o, e in (first, second)]
    return out


def _steps(stdout):
    rows = [STEP.match(line) for line in stdout.splitlines()]
    assert all(rows), stdout
    return [(int(m.group(1)), float(m.group(2))) for m in rows]


@pytest.mark.parametrize("leg", [0, 1], ids=["fresh", "resumed"])
def test_train_losses_match_the_jax_cli(runs, leg):
    (jrc, jout, _), (prc, pout, _) = runs["jax"][leg], runs["port"][leg]
    assert jrc == prc == 0
    jsteps, psteps = _steps(jout), _steps(pout)
    assert [s for s, _ in psteps] == [s for s, _ in jsteps] \
        == ([1, 2, 3] if leg == 0 else [4, 5])
    for (_, a), (_, b) in zip(psteps, jsteps):
        assert abs(a - b) <= TOL


def test_train_notes_match_the_jax_cli(runs):
    """``saved DIR`` after each run, ``resumed from DIR at step 3``
    before the second."""
    def notes(err):
        return [line for line in err.splitlines()
                if line.startswith(("resumed from", "saved "))]

    for leg in (0, 1):
        assert notes(runs["port"][leg][2]) == notes(runs["jax"][leg][2])
    assert notes(runs["port"][1][2])[0] == "resumed from DIR at step 3"


def test_train_refuses_what_waits_for_the_pipeline_and_experts(monkeypatch,
                                                               capsys):
    """What the JAX ``cmd_train`` and ``_cmd_train_moe`` refuse, the port
    refuses with the same exit code 2 and last stderr line, before any
    world starts: ``--pp 2`` on a world of one, ``--pp 5`` (does not
    divide 12 layers), ``--pp 2 --scan``, mixtral with ``--pp``, an
    unknown mixtral variant and ``llama-tiny``.  The JAX CLI runs on one
    device (``jax.devices`` patched), the port on one CPU rank."""
    monkeypatch.setenv("DLS_PLATFORM", "cpu")
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:1])
    for argv in (["train", "--pp", "2"], ["train", "--pp", "5"],
                 ["train", "--pp", "2", "--scan"],
                 ["train", "--model", "mixtral-tiny", "--pp", "2"],
                 ["train", "--model", "mixtral-huge"],
                 ["train", "--model", "llama-tiny"]):
        assert jmain(argv) == 2
        want = capsys.readouterr().err.strip().splitlines()[-1]
        assert main(argv) == 2
        got = capsys.readouterr()
        assert got.out == "" and got.err.strip().splitlines() == [want], argv
