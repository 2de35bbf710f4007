"""On the card: a whole run at the smoke sizes, through the card's kernels,
is correct, and the control is not; so is a run of the tests' own
configuration with a ``hierarchy`` section."""

import json

import pytest

from lmibench import run

BATCH = ["laion10m-int8.batch10k", "laion300k-bf16.batch10k"]


def card_smoke(capsys, workload, *extra):
    rc = run.main(["--workload", workload, "--seed", "3000000011",
                   "--seconds", "1", "--trace", "1", "--smoke", *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", BATCH)
def test_smoke_run_on_the_card(card, capsys, workload):
    result = card_smoke(capsys, workload)
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"]
    assert 0 < result["metrics"]["probe_roofline_pct"]["value"] <= 105


@pytest.mark.cuda
@pytest.mark.parametrize("workload", BATCH)
def test_control_on_the_card_is_not_correct(card, capsys, workload):
    assert card_smoke(capsys, workload, "--control")["correct"] is False


@pytest.mark.cuda
def test_hierarchical_smoke_run_on_the_card(card, capsys, hier_cell):
    result = card_smoke(capsys, hier_cell)
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert 0 < result["metrics"]["probe_roofline_pct"]["value"] <= 105
    assert card_smoke(capsys, hier_cell, "--control")["correct"] is False
