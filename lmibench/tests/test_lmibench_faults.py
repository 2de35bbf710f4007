"""A whole run on the CPU at the configurations' smoke sizes, with the
card's check skipped: a sound program comes out correct, and `correct`
comes out false with the timed path broken underneath (a stale answer, half
the batch left out, an answer altered where it is produced) and with the
control in the program's place. The limits are the configurations' own,
set from card runs at full size."""

import importlib
import json
import sys

import numpy as np
import pytest

from lmibench import cells, run
from lmibench.system import System


class Stale(System):
    """Answers each request with the answer to the one before it."""

    def search(self, queries_nav, queries_search):
        out = super().search(queries_nav, queries_search)
        last = getattr(self, "_last", None)
        self._last = out
        if last is None or last[0].shape != out[0].shape:
            return out
        return last


class HalfBatch(System):
    """Searches the first half of each request and fills the rest of the
    answer with the first half's rows."""

    def search(self, queries_nav, queries_search):
        half = max(1, len(queries_nav) // 2)
        d, i = super().search(queries_nav[:half], queries_search[:half])
        take = np.arange(len(queries_nav)) % half
        return d[take], i[take]


class Altered(System):
    """Alters one id of each answer where it is produced."""

    def search(self, queries_nav, queries_search):
        d, i = super().search(queries_nav, queries_search)
        i = i.copy()
        i[0, 0] = i[0, 0] % self.config["rows"] + 1
        return d, i


def smoke(capsys, workload, factory=System, extra=(), seconds="0.3"):
    rc = run.main(["--workload", workload, "--seed", "3000000007",
                   "--seconds", seconds, "--trace", "0", "--smoke", *extra],
                  device="cpu", system_factory=factory)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(result)[-1] == "check"
    return result


BATCH = ["laion10m-int8.batch10k", "laion300k-bf16.batch10k"]


@pytest.mark.parametrize("workload", BATCH)
def test_a_sound_run_is_correct(capsys, workload):
    result = smoke(capsys, workload)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 0
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("fault", [Stale, HalfBatch, Altered])
@pytest.mark.parametrize("workload", BATCH)
def test_a_broken_timed_path_is_not_correct(capsys, workload, fault):
    # a stale answer shows from the window's second request on: the window
    # is long enough for a few even on a loaded CPU
    result = smoke(capsys, workload, fault, seconds="1.5")
    assert result["attempted"] >= 2
    assert result["correct"] is False


@pytest.mark.parametrize("workload", BATCH)
def test_the_control_is_not_correct(capsys, workload):
    result = smoke(capsys, workload, extra=("--control",))
    assert result["correct"] is False
    gap = result["check"]["dist_rms_gap"]
    assert gap["value"] > gap["max"]


def test_a_reader_that_loads_jax_stops_the_result(capsys, monkeypatch,
                                                  tmp_path):
    """The look for JAX in `sys.modules` comes after every reader has run:
    a reader that loads a stub module named as JAX leaves no result line."""
    stub = run.FORBIDDEN[0]
    (tmp_path / stub).mkdir()
    (tmp_path / stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    reader = cells.reader

    def loading_reader(name):
        read = reader(name)

        def read_and_load(ctx):
            importlib.import_module(stub)
            return read(ctx)
        return read_and_load

    monkeypatch.setattr(cells, "reader", loading_reader)
    assert stub not in sys.modules
    try:
        rc = run.main(["--workload", BATCH[1], "--seed", "3000000009",
                       "--seconds", "0.2", "--trace", "0", "--smoke"],
                      device="cpu")
    finally:
        sys.modules.pop(stub, None)
    captured = capsys.readouterr()
    assert rc != 0
    assert captured.out.strip() == ""
    assert stub in captured.err.splitlines()[-1]


def test_judged_requests_are_the_first_pass_and_a_seeded_share():
    a = run.judged_requests(2**33 + 1, 16)
    assert a[:16].all()
    assert (a == run.judged_requests(2**33 + 1, 16)).all()
    assert not (a == run.judged_requests(7, 16)).all()
    assert abs(a[16:].mean() - run.JUDGED_SHARE) < 0.01


def test_kept_answers_are_copies_and_odd_ones_stay_as_they_are():
    from lmibench.check import Kept

    kept = Kept(2, 3, 2)
    d = np.arange(6, dtype=np.float32).reshape(3, 2)
    i = np.arange(1, 7, dtype=np.int32).reshape(3, 2)
    where = kept.put((d, i))
    d[0, 0], i[0, 0] = 9, 9           # the program reuses its arrays
    got_d, got_i = kept.get(where)
    assert got_d[0, 0] == 0 and got_i[0, 0] == 1 and got_i.dtype == np.int64
    odd = (d[:2], i[:2])               # a short answer is held as it is
    assert kept.get(kept.put(odd)) is odd
    assert kept.put((d, i)) == 1 and kept.put((d, i)) is None
