"""The dispatcher's per-layer readers on synthetic readings: the window's
counter deltas as the serving runner gathers them, and nothing to read (no
dispatcher, no run, or a program without the counter) as None."""

from __future__ import annotations

import pytest

from portbench import spec

WINDOW = {"device_batches": 130, "merged_requests": 2080, "queue_wait_s": 166.4,
          "dispatch_host_s": 1.3}


def test_queue_wait_ms_by_hand():
    read = spec.metric_reader("lift.queue_wait_ms").read
    assert read({"coalescer": WINDOW}) == pytest.approx(1e3 * 166.4 / 2080)


def test_dispatch_host_ms_per_run_by_hand():
    read = spec.metric_reader("lift.dispatch_host_ms_per_run").read
    assert read({"coalescer": WINDOW}) == pytest.approx(1e3 * 1.3 / 130)


@pytest.mark.parametrize("name", ["lift.queue_wait_ms", "lift.dispatch_host_ms_per_run"])
@pytest.mark.parametrize("readings", [
    {},
    {"coalescer": {}},
    {"coalescer": dict(WINDOW, device_batches=0, merged_requests=0)},
    {"coalescer": {"device_batches": 130, "merged_requests": 2080}},  # no such counter
], ids=["no_dispatcher", "empty", "no_run", "no_counter"])
def test_nothing_to_read_is_none(name, readings):
    assert spec.metric_reader(name).read(readings) is None
