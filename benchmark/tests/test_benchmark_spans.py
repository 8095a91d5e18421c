"""The per-layer device times read from the program's spans
(``benchmark/spans.py`` and its readers) on a hand-built trace: nested
``wt.*`` spans, enqueue calls (a runtime call with its own driver call
inside, which is one enqueue) and the device operations they enqueued, one
stream."""

import types

import pytest
from tiny_cell import REPO  # noqa: F401

from benchmark import spans, trace
from benchmark.run import metric_reader

MS_METRICS = ("detector_device_ms", "preprocess_device_ms", "render_device_ms", "decode_device_ms",
              "predictor_device_ms", "motor_device_ms", "engine_device_ms")
US = 1_000  # ns


def _cycle(t0: int) -> tuple[list, list, list]:
    """One cycle from ``t0`` (µs on the trace's clock, as ns): spans, enqueue
    calls and device operations; each operation's length says whose it is
    (render 2, preprocess 3, detector 11, decode 5, predict 7, motor 13,
    cycle 17, detect 19 µs), two detect sub-batches."""
    host, ops = [], []

    def call(name, t, dur):  # a call at t µs and the operation it enqueues
        host.append((name, t0 + t * US, t0 + (t + 1) * US))
        op = "Memcpy HtoD (Pageable -> Device)" if "Memcpy" in name else "Memset (Device)" if "Memset" in name else "k"
        ops.append((op, t0 + (t + 50) * US, t0 + (t + 50 + dur) * US))

    spans_ = [("wt.cycle", 0, 400)]
    call("cudaLaunchKernel", 1, 17)  # the cycle's own
    for base in (10, 110):
        spans_ += [("wt.detect", base, base + 90), ("wt.render", base + 1, base + 10),
                   ("wt.preprocess", base + 11, base + 20), ("wt.detector", base + 21, base + 40),
                   ("wt.decode", base + 41, base + 50)]
        call("cudaLaunchKernel", base + 2, 2)
        call("cudaMemcpyAsync", base + 12, 3)
        call("cuLaunchKernelEx", base + 22, 11)
        call("cudaLaunchKernelExC_v11060", base + 30, 11)
        host.append(("cuLaunchKernel", t0 + (base + 30) * US + 100, t0 + (base + 30) * US + 500))  # inside
        call("cudaLaunchKernel", base + 42, 5)
        call("cudaMemsetAsync", base + 60, 19)  # the detect call's own
    spans_ += [("wt.predict", 210, 230), ("wt.motor", 240, 260)]
    call("cudaLaunchKernel", 215, 7)
    call("cudaLaunchKernel", 245, 13)
    host += [(n, t0 + s * US, t0 + e * US) for n, s, e in spans_]
    host.append(("aten::add", t0 + 244 * US, t0 + 247 * US))
    return host, ops


def _trace(cycles: int = 3, log_fetch: bool = True) -> trace.Trace:
    tr = trace.Trace(window_ns=(0, 10_000 * US))
    end = 400 * US * cycles + 100 * US
    tr.host_ops.append(("wt.run", 0, end))
    for c in range(cycles):
        host, ops = _cycle(10 * US + c * 400 * US)
        tr.host_ops += host
        tr.device_ops += ops
    if log_fetch:  # after the run: outside every span
        tr.host_ops.append(("cudaMemcpyAsync", end + 10 * US, end + 12 * US))
        tr.device_ops.append(("Memcpy DtoH (Device -> Pageable)", end + 20 * US, end + 50 * US))
    tr.device_ops.append(("Command Buffer Full", 5 * US, 6 * US))
    tr.device_ops.sort(key=lambda op: op[1])
    tr.kernels = [op for op in tr.device_ops if trace.is_kernel(op[0], False)]
    return tr


def _ctx(tr, on_device=True):
    return types.SimpleNamespace(trace=tr, on_device=on_device)


def _read(ctx) -> dict:
    return {name: metric_reader(name)(ctx) for name in (*MS_METRICS, "detect_calls_per_cycle", "span_coverage")}


def test_layers_self_times_and_coverage():
    tr = _trace()
    got = _read(_ctx(tr))
    want_us = {"detector_device_ms": 44, "preprocess_device_ms": 6, "render_device_ms": 4, "decode_device_ms": 10,
               "predictor_device_ms": 7, "motor_device_ms": 13, "engine_device_ms": 17 + 2 * 19}
    for name, us in want_us.items():
        assert got[name] == pytest.approx(us * 1e-3), name
    assert got["detect_calls_per_cycle"] == 2.0
    attributed = 3 * sum(want_us.values())
    assert got["span_coverage"] == pytest.approx(100.0 * attributed / (attributed + 30))
    # the seven ms metrics times the cycles add up to the attributed time
    lay = spans.attribute(tr)
    assert lay.cycles == 3 and lay.counts["wt.detect"] == 6 and lay.attributed_ns == attributed * US
    assert sum(got[name] for name in MS_METRICS) * lay.cycles == pytest.approx(lay.attributed_ns * 1e-6)


def test_a_runtime_call_and_its_driver_call_are_one_enqueue():
    tr = _trace(cycles=1)
    calls = spans.enqueue_calls(tr.host_ops)
    assert len(calls) == len([op for op in tr.device_ops if op[0] not in spans.PSEUDO]) == 1 + 2 * 6 + 2 + 1


def test_a_step_back_of_the_device_clock_is_admitted():
    """CUPTI's device timestamps may step back mid-trace: operations on an
    idle card then read as starting before their calls."""
    tr = _trace()
    last, idle, step = 10 * US + 2 * 400 * US, 100_000 * US, 9_700 * US  # the third cycle after 100 ms idle
    tr.host_ops = [(n, s, e + idle) if n == "wt.run" else (n, s + idle, e + idle) if s >= last else (n, s, e)
                   for n, s, e in tr.host_ops]
    tr.device_ops = [(n, s + idle - step, e + idle - step) if s >= last else (n, s, e) for n, s, e in tr.device_ops]
    calls = spans.enqueue_calls(tr.host_ops)
    first_late = min((op for op in tr.device_ops if op[1] >= last), key=lambda op: op[1])
    assert first_late[1] < next(c[1] for c in calls if c[1] >= last)  # it reads as starting before its call
    got, want = _read(_ctx(tr)), _read(_ctx(_trace()))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("fault", ["extra_op", "missing_call", "copy_for_fill", "op_before_call", "no_spans",
                                   "no_cycle", "cpu_run"])
def test_every_reader_is_none_where_the_pairing_fails(fault):
    tr = _trace()
    on_device = True
    if fault == "extra_op":
        tr.device_ops.append(("kernel", 9_000 * US, 9_001 * US))
    elif fault == "missing_call":
        tr.host_ops.remove(next(op for op in tr.host_ops if op[0] == "cudaMemsetAsync"))
    elif fault == "copy_for_fill":  # as many operations as calls, of the wrong kinds
        i = next(i for i, op in enumerate(tr.device_ops) if op[0].startswith("Memset"))
        tr.device_ops[i] = ("Memcpy DtoD (Device -> Device)", *tr.device_ops[i][1:])
    elif fault == "op_before_call":  # the first operation begins before its call, by more than a clock step
        first = min((op for op in tr.device_ops if op[0] not in spans.PSEUDO), key=lambda op: op[1])
        tr.device_ops.remove(first)
        call = spans.enqueue_calls(tr.host_ops)[0]
        tr.device_ops.append((first[0], call[1] - spans.CLOCK_STEP_NS - 1, first[2]))
    elif fault == "no_spans":
        tr.host_ops = [op for op in tr.host_ops if not op[0].startswith("wt.")]
    elif fault == "no_cycle":
        tr.host_ops = [op for op in tr.host_ops if op[0] != "wt.cycle"]
    else:
        on_device = False
    assert all(v is None for v in _read(_ctx(tr, on_device)).values())


def test_a_layer_whose_span_never_opened_reads_none():
    tr = _trace()
    tr.host_ops = [op for op in tr.host_ops if op[0] != "wt.motor"]
    got = _read(_ctx(tr))
    assert got["motor_device_ms"] is None
    assert got["engine_device_ms"] == pytest.approx((17 + 2 * 19 + 13) * 1e-3)  # the motor's work is the cycle's
