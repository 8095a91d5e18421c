"""The port's profiling tools against the JAX package's.

Reference: ``wtracker_tpu/utils/profiling.py``.  ``StageTimer`` keeps the
same fields, ``report()`` text layout and ``reset()``: given the same
recorded times, both packages' reports are the same text.
``device_trace`` writes a ``torch.profiler`` trace (Chrome trace JSON)
under its directory, holding the traced block's operators, and names the
file; without a directory it writes nothing, and the program's spans
(``span``) come on inside it.
"""

import json
import re
import time

import pytest
import torch

from wtracker_tpu.utils.profiling import StageTimer as JaxStageTimer
from wtracker_tpu_torch.utils.profiling import StageTimer, device_trace, span


@pytest.mark.parametrize("sync", [True, False])
def test_stage_timer_accumulates_and_reports(sync):
    timer = StageTimer(sync=sync)
    for _ in range(3):
        with timer("detect"):
            torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.002)
    with timer("upload"):
        pass
    assert timer.counts == {"detect": 3, "upload": 1}
    assert timer.totals["detect"] >= 0.006 > timer.totals["upload"]
    lines = timer.report().splitlines()
    assert lines[0].startswith("detect") and re.search(r"\(3x, +[\d.]+ ms/call, +[\d.]+%\)$", lines[0])
    timer.reset()
    assert timer.totals == {} and timer.counts == {} and timer.report() == ""


def test_report_is_the_jax_text():
    totals, counts = {"detect": 0.1234, "upload": 0.0456, "log": 0.00789}, {"detect": 3, "upload": 2, "log": 7}
    ours, theirs = StageTimer(sync=False), JaxStageTimer(sync=False)
    for t in (ours, theirs):
        t.totals.update(totals)
        t.counts.update(counts)
    assert ours.report() == theirs.report()
    assert [f for f in StageTimer.__dataclass_fields__] == [f for f in JaxStageTimer.__dataclass_fields__]


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(32, 32).mm(torch.ones(32, 32))
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1 and prof is not None and prof.trace_path == str(files[0])
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_device_trace_without_a_directory_records_spans(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with device_trace() as prof:
        with span("wt.cycle"):
            torch.ones(8, 8).mm(torch.ones(8, 8))
    assert prof.trace_path is None and list(tmp_path.iterdir()) == []
    names = [e.name for e in prof.events()]
    assert names.count("wt.cycle") == 1 and "aten::mm" in names
