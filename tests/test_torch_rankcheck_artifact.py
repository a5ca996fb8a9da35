"""The port's rank-check record (``eval/rankcheck_artifact.py``): the usage
exit, the one-line refusal below four cards, the exit rule over the two
legs (monkeypatched: the legs measure cards) and the record's name.
Kendall's tau is not asserted here: it is a wall-clock measurement of
the cards."""

from __future__ import annotations

import json

import pytest
import torch

from distributed_llm_scheduler_tpu_torch.eval import rankcheck_artifact as ra


@pytest.fixture(autouse=True)
def at_tmp(monkeypatch, tmp_path):
    monkeypatch.setattr(ra, "REPO_ROOT", str(tmp_path))


def test_usage_exit(tmp_path, capsys):
    assert ra.main([]) == 2
    assert ra.main(["x"]) == 2
    assert "RANKCHECK_TORCH_r{N}.json" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("where", ["cpu", "one card", "no card"])
def test_fewer_than_four_cards_is_one_line(where, tmp_path, monkeypatch, capsys):
    if where == "cpu":
        monkeypatch.setenv("DLS_PLATFORM", "cpu")
    else:
        monkeypatch.delenv("DLS_PLATFORM", raising=False)
        monkeypatch.delenv("DLS_FORCE_CPU", raising=False)
        monkeypatch.setattr(torch.cuda, "device_count",
                            lambda: 1 if where == "one card" else 0)
    monkeypatch.setattr(ra, "flagship_leg", lambda: pytest.fail("ran a leg"))
    assert ra.main(["23"]) == 2
    (line,) = capsys.readouterr().err.strip().splitlines()
    if where == "no card":
        assert line.startswith("rankcheck_artifact: no CUDA device visible")
    else:
        assert line == ("rankcheck_artifact needs >= 4 cards (1 distinct "
                        "device(s) here; nodes sharing a card copy nothing "
                        "between them)")
    assert list(tmp_path.iterdir()) == []


def _leg(agree, tau):
    return {"winner_agreement": agree, "kendall_tau": tau}


@pytest.mark.parametrize("flagship,separating,rc", [
    (_leg(True, 0.8), _leg(True, 1.0), 0),
    (_leg(True, 0.6), _leg(True, 1.0), 1),
    (_leg(False, 1.0), _leg(True, 1.0), 1),
    (_leg(True, 1.0), _leg(None, 0.9), 1),
])
def test_exit_rule_and_record(flagship, separating, rc, tmp_path, monkeypatch):
    """0 only when both legs agree on the winner with tau >= 0.8; the
    record is ``RANKCHECK_TORCH_r{N:02d}.json`` with the card beside it."""
    monkeypatch.setattr(ra, "_distinct_cards", lambda: 4)
    monkeypatch.setattr(ra, "flagship_leg", lambda: flagship)
    monkeypatch.setattr(ra, "separating_leg", lambda: separating)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    from distributed_llm_scheduler_tpu_torch.eval import bench

    monkeypatch.setattr(bench, "nvidia_smi_line",
                        lambda dev: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert ra.main(["7"]) == rc
    (path,) = tmp_path.iterdir()
    assert path.name == "RANKCHECK_TORCH_r07.json"
    rec = json.loads(path.read_text())
    assert rec["round"] == 7 and rec["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert rec["flagship"] == flagship and rec["separating"] == separating
