"""The reduction of the program's spans (benchmark/spans.py) on events made
by hand, beside benchmark/trace.py's reduction of the same events, and on
a traced slice of each traffic kind at the small size on the CPU."""

import math
from types import SimpleNamespace

import pytest

from benchmark import harness, spans, trace
from benchmark.tests.conftest import CELLS, SPEC, run_small

MAIN, AUTOGRAD = 1, 2


def _x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    """One step: a forward whose two kernels are launched from the main
    thread, a backward whose two kernels are launched from autograd's
    thread, a kernel at the step's end, and the benchmark's read-back
    after it. Times in us."""
    return [
        _x("user_annotation", "bflow.step#0", 0, 100),
        _x("user_annotation", "bflow.forward", 10, 40),
        _x("user_annotation", "bench.forward", 9, 42),
        _x("user_annotation", "bflow.backward", 60, 30),
        _x("user_annotation", "bench.backward", 59, 32),
        _x("cpu_op", "aten::conv2d", 11, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 65, 2, AUTOGRAD, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 70, 2, AUTOGRAD, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", 95, 2, corr=5),
        _x("cuda_runtime", "cudaMemcpyAsync", 105, 1, corr=6),
        _x("kernel", "conv", 15, 10, 7, corr=1),
        _x("kernel", "gemm", 26, 14, 7, corr=2),
        _x("kernel", "dgrad", 66, 14, 7, corr=3),
        _x("kernel", "wgrad", 82, 6, 7, corr=4),
        _x("kernel", "sum", 96, 3, 7, corr=5),
        _x("gpu_memcpy", "Memcpy DtoH", 106, 4, 7, corr=6),
    ]


def test_reduce_by_hand():
    got = spans.reduce(_events())
    assert set(got) == {"step", "forward", "backward"}
    want = {  # us: device launched inside, idle = interval - busy in it
        "forward": (1, 40, 10 + 14, 40 - 24),
        "backward": (1, 30, 14 + 6, 30 - 20),
        "step": (1, 100, 10 + 14 + 14 + 6 + 3, 100 - 47),
    }
    for name, (calls, wall, device, idle) in want.items():
        g = got[name]
        assert g["calls"] == calls
        assert g["wall_s"] == pytest.approx(wall / 1e6)
        assert g["device_s"] == pytest.approx(device / 1e6)
        assert g["idle_s"] == pytest.approx(idle / 1e6)


def test_backward_launches_count_on_any_thread():
    """trace.py's same-thread match gives a bench.* range around the
    backward none of the launches autograd's thread made; the span holds
    them."""
    old = trace.reduce(_events(), 1e-4)
    assert old["ranges"]["backward"] == 0.0
    assert old["ranges"]["forward"] == pytest.approx(24e-6)
    assert spans.reduce(_events())["backward"]["device_s"] == \
        pytest.approx(20e-6)


def test_checks_by_hand():
    events = _events()
    events.append(_x("cuda_runtime", "cudaLaunchKernel", 120, 2, corr=8))
    events.append(_x("kernel", "early", 119, 1, 7, corr=8))
    got = spans.checks(events)
    assert got["outside_kernel_s"] == pytest.approx(1e-6)
    assert got["outside_copy_s"] == pytest.approx(4e-6)
    assert got["busy_s"] == pytest.approx((47 + 4 + 1) / 1e6)
    assert got["early_starts"] == 1
    assert got["worst_early_us"] == pytest.approx(1.0)


def test_spans_leave_trace_reduce_as_it_was():
    """The program's spans change none of trace.reduce's numbers: its
    ranges, kernels and busy time come out as without them; only the
    names of idle gaps may move to a span."""
    events = _events()
    plain = [e for e in events if not e["name"].startswith(spans.PREFIX)]
    got, want = trace.reduce(events, 1e-4), trace.reduce(plain, 1e-4)
    for key in ("window_s", "busy_s", "ranges", "range_calls", "kernels"):
        assert got[key] == want[key], key
    assert got["breakdown"]["device_ops"] == want["breakdown"]["device_ops"]


@pytest.mark.parametrize("cell,per_request", [
    ("dsec_ei.eval_b8", {"step": 1, "forward": 1, "encoders": 1, "corr": 1,
                         "update": 2}),
    ("mf_ei.train_b3", {"step": 1, "forward": 1, "encoders": 1, "corr": 1,
                        "update": 2, "loss": 1, "backward": 1,
                        "optimizer": 2}),
])
def test_traced_slice_holds_the_spans(cell, per_request, monkeypatch):
    """A traced run of the cell at the small size: every request's spans,
    no device activity on the CPU, and no time outside the steps."""
    seen = {}
    whole = trace.reduce

    def reduce_both(events, wall):
        seen.update(spans=spans.reduce(events), checks=spans.checks(events))
        return whole(events, wall)

    monkeypatch.setattr(trace, "reduce", reduce_both)
    result, run = run_small(cell, trace=True)
    assert result["correct"], result["checks"]
    n = run.slice["requests"]
    assert {k: v["calls"] for k, v in seen["spans"].items()} == {
        k: c * n for k, c in per_request.items()}
    assert all(v["device_s"] == 0 and v["wall_s"] > 0
               for v in seen["spans"].values())
    assert seen["checks"]["busy_s"] == 0
    assert seen["checks"]["early_starts"] == 0


# the readers of the program's spans: (span, key) each reads
SPAN_READERS = {"corr_ms": ("corr", "device_s"),
                "forward_idle_ms": ("forward", "idle_s"),
                "loss_idle_ms": ("loss", "idle_s"),
                "backward_ms": ("backward", "device_s"),
                "backward_idle_ms": ("backward", "idle_s")}


@pytest.mark.parametrize("kind,per", [("eval", "units"), ("stream", "units"),
                                      ("train", "requests")])
@pytest.mark.parametrize("reader", sorted(SPAN_READERS))
def test_span_readers_by_hand(reader, kind, per):
    """Each reader gives 1e3 x its span's device or idle seconds of the
    hand-made slice, per field (eval, stream) or per step (train), and
    nothing where the slice has no such span."""
    span, key = SPAN_READERS[reader]
    reduced = spans.reduce(_events())
    reduced[span] = reduced.get(span, reduced["forward"])
    slice_ = {"units": 6, "requests": 2, "spans": reduced}
    run = SimpleNamespace(slice=slice_, workload={"kind": kind})
    mod = harness.reader(reader)
    assert mod.read(run) == pytest.approx(
        1e3 * reduced[span][key] / slice_[per])
    del reduced[span]
    assert mod.read(run) is None
    run.slice = {}
    assert mod.read(run) is None


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_span_metrics(cell):
    """A traced run of every listed cell at the small size reports each
    span metric BENCHMARK.json lists for it, finite (0 device ms on the
    CPU), and its slice holds the spans' reduction."""
    result, run = run_small(cell, trace=True)
    assert result["correct"], result["checks"]
    names = [m["name"] for m in harness.reported(cell, True, SPEC)
             if m["name"].split(".")[0] in SPAN_READERS]
    assert names
    for name in names:
        assert math.isfinite(result["metrics"][name]["value"]), name
    assert {"step", "forward", "corr"} <= set(run.slice["spans"])
