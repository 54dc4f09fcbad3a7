"""The reduction of the program's spans (``program_spans.py``) on a
synthetic trace: the kernel attribution of ``trace.span_view`` is the same
with nested program spans stripped as without them; inclusive and self
device time, launch counts, calls and host time per span; the autograd
thread's launches go to the span open on the root's thread; idle gaps are
named by the bench span and the innermost program span."""

from __future__ import annotations

import pytest

from benchmark import program_spans, trace

MAIN, AUTOGRAD = 1, 2


def note(name, ts, dur, tid=MAIN):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid, "ph": "X"}


def launch(corr, ts, tid=MAIN):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 1, "tid": tid, "args": {"correlation": corr}}


def op(corr, name, ts, dur):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


# a frame and a step, in microseconds: K5's wrapper span (the benchmark's)
# inside the program's block span, a weight preparation inside K5's span,
# a launch outside any program span, and two launches from the autograd
# engine's thread during (and after) the backward
BENCH = [note("bench.window", 0, 1000), note("bench.render_u8", 0, 500),
         note("bench.train_step", 500, 400), note("K5", 30, 120)]
PROGRAM = [note("pcss.engine.render_u8", 10, 390), note("pcss.unet.dec_0", 20, 180),
           note("pcss.ops.weight_prep", 35, 15), note("pcss.unet.resize", 210, 90),
           note("pcss.step", 500, 400), note("pcss.step.backward", 600, 200)]
DEVICE = [launch(1, 40), op(1, "quantize_elementwise", 41, 5),
          launch(2, 100), op(2, "int8_taps_kernel", 101, 50),
          launch(3, 220), op(3, "gemm", 222, 30),
          launch(4, 450), op(4, "copy", 452, 10),
          launch(5, 700, AUTOGRAD), op(5, "gemm_backward", 701, 20),
          launch(6, 850, AUTOGRAD), op(6, "add", 851, 20)]


class K5:
    NAMES = ("int8_taps_kernel",)

    @staticmethod
    def bound_s(call):
        return 10e-6


def test_stripped_program_spans_leave_the_kernel_attribution_as_it_was():
    calls = [("K5", {"args": [], "kwargs": {}})]
    mods = {"K5": K5}
    bare = trace.span_view(BENCH + DEVICE, calls, 1, mods)
    nested = trace.span_view(program_spans.strip(PROGRAM + BENCH + DEVICE), calls, 1, mods)
    for key in ("roofline", "kernel_s_per_unit", "glue_s_per_unit"):
        assert nested[key] == bare[key]
    assert bare["kernel_s_per_unit"] == {"K5": pytest.approx(50e-6)}
    assert bare["roofline"] == {"K5": pytest.approx(20.0)}


@pytest.mark.parametrize("units", [1, 2])
def test_program_view_inclusive_self_launches_and_the_autograd_thread(units):
    got = program_spans.program_view(PROGRAM + BENCH + DEVICE, units)
    us = 1e-6 / units
    want = {  # name: incl, self, launches, calls, host (microseconds, counts)
        "engine.render_u8": (85, 0, 3, 1, 390),
        "unet.dec_0": (55, 50, 2, 1, 180),
        "ops.weight_prep": (5, 5, 1, 1, 15),
        "unet.resize": (30, 30, 1, 1, 90),
        # the autograd thread has no span open: the root's thread's span
        "step": (40, 20, 2, 1, 400),
        "step.backward": (20, 20, 1, 1, 200),
    }
    assert set(got) == set(want)
    for name, (incl, own, n, calls, host) in want.items():
        assert got[name] == {"incl_s": pytest.approx(incl * us),
                             "self_s": pytest.approx(own * us),
                             "launches": n / units, "calls": calls / units,
                             "host_s": pytest.approx(host * us)}, name


def test_host_time_of_a_span_nested_in_its_own_name_counts_once():
    events = [note("pcss.unet.resize", 0, 100), note("pcss.unet.resize", 10, 20)]
    got = program_spans.program_view(events, 1)["unet.resize"]
    assert got["calls"] == 2 and got["host_s"] == pytest.approx(100e-6)


def test_idle_gaps_carry_the_program_span_the_host_was_in():
    gaps = program_spans.named_gaps(PROGRAM + BENCH + DEVICE)
    assert [w for w, _ in gaps] == [
        "render_u8", "render_u8 > pcss.unet.resize",
        "train_step > pcss.step.backward", "train_step > pcss.step",
        "render_u8 > pcss.unet.dec_0", "render_u8 > pcss.ops.weight_prep",
        "render_u8"]
    assert [d for _, d in gaps] == pytest.approx(
        [239e-6, 200e-6, 130e-6, 129e-6, 71e-6, 55e-6, 41e-6])
    # without program spans, the gaps are named as the traced segment names them
    bare = program_spans.named_gaps(BENCH + DEVICE)
    assert bare == trace.span_view(BENCH + DEVICE, [], 1, {})["idle_gaps"]
