"""Idle share, gaps, labels and the DP bound on hand-made intervals and
shapes, and the per-layer readers on a hand-made context."""

import importlib.util
import os

import numpy as np
import pytest

from harness import roofline, trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def metric(name):
    s = importlib.util.spec_from_file_location(
        name, os.path.join(BENCH, "metrics", f"{name}.py"))
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def hand_trace():
    tr = trace.Trace()
    tr.window = (1000, 2000)
    tr.offset = 500                          # device = host + 500
    tr.ops = [("void dp_score_kernel<5, false>(int)", 1100, 1200, "kernel"),
              ("elementwise", 1150, 1300, "kernel"),      # overlaps
              ("Memcpy DtoH", 1500, 1600, "gpu_memcpy"),
              ("void dp_score_wide_kernel<9>(int)", 1900, 2100, "kernel")]
    tr.kernels = 3
    return tr


def test_union_busy_gaps():
    assert trace.union([(5, 9), (1, 3), (2, 4), (8, 12)], 0, 10) == [
        [1, 4], [5, 10]]
    tr = hand_trace()
    assert trace.busy_ns(tr) == 200 + 100 + 100   # 1100-1300, 1500-1600, 1900-2000
    assert trace.gaps(tr) == [(1000, 1100), (1300, 1500), (1600, 1900)]


def test_breakdown_labels_gaps_by_open_span():
    tr = hand_trace()
    # host spans: (tag, main thread, t0, t1, nested)
    spans = [("reads", True, 750, 1100, False),     # device 1250-1600
             ("submit", True, 1090, 1200, False),   # inner, device 1590-
             ("finish", False, 0, 5000, False)]     # another thread
    b = trace.breakdown(tr, spans)
    assert b["device_ops"][0] == ["void dp_score_wide_kernel<9>(int)", 2e-7]
    # gaps at device 1600, 1300, 1000 start at host 1100, 800, 500
    assert b["idle_gaps"] == [["submit", 3e-7], ["reads", 2e-7],
                              ["no span", 1e-7]]
    assert trace.open_span(spans, 1095) == "submit"


def test_idle_share_reader():
    m = metric("device.idle_share")

    class Ctx:
        trace = hand_trace()
    assert m.read(Ctx) == pytest.approx(1 - 400 / 1000)
    Ctx.trace = None
    assert m.read(Ctx) is None


def test_dp_bound():
    # C = 1024 candidates of 100 bp reads (L = 104), W = 136
    C, L, W = 1024, 104, 136
    cells = C * 100 * (W + 1)
    ops_s = cells * 8.5 / (2 * 16.75e12)
    by = roofline.dp_bytes(C, L, W, False)
    assert by == 4 * (2 * C * L + C + C * W + C * (L + 1) + C)
    assert roofline.dp_bound_s(cells, C, L, W, False) == pytest.approx(ops_s)
    # a window with nothing to fill is bound by its bytes
    assert roofline.dp_bound_s(0, C, L, W, True) == pytest.approx(
        roofline.dp_bytes(C, L, W, True) / 3.35e12)


def test_dp_roofline_reader():
    m = metric("ops.dp_roofline")

    class Ctx:
        trace = hand_trace()
        dp_shapes = [(4, 8, 10, False, np.array([8, 8, 0, 5]))]
    bound = roofline.dp_bound_s(21 * 11, 4, 8, 10, False)
    dev_s = (100 + 200) / 1e9        # the two DP kernels' device times
    assert m.read(Ctx) == pytest.approx(100 * bound / dev_s)
    Ctx.dp_shapes = []
    assert m.read(Ctx) is None


def test_span_readers():
    spans = [("reads", True, 0, 4000, False),
             ("reads", True, 1000, 2000, True),    # nested: counted once
             ("reads", False, 0, 9000, False),     # not the main thread
             ("submit", True, 0, 3000, False),
             ("finish", False, 0, 5000, False),
             ("finish", False, 1000, 6000, False)]

    class Ctx:
        reads = 2
        trace = None
    Ctx.spans = spans
    assert metric("reads.parse_us_per_read").read(Ctx) == 2.0
    assert metric("pipeline.submit_us_per_read").read(Ctx) == 1.5
    assert metric("emit.finish_us_per_read").read(Ctx) == 5.0
    assert metric("pipeline.launches_per_kread").read(Ctx) is None
    Ctx.trace = hand_trace()
    assert metric("pipeline.launches_per_kread").read(Ctx) == 1500.0
