"""The trace reader's split of the profiler's raw events: a range that
``record_function`` marks shows on the card under its host name, whatever
the range is called and whether or not the card's copy is flagged as a user
annotation, and never counts as a device operation or as busy time; the
busy time that ``device_idle.*`` reads leaves the collectives out."""

from __future__ import annotations

import torch

from perfbench.harness import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, device, start, end, marked=False):
        self._row = (name, device, start, end, marked)

    def name(self):
        return self._row[0]

    def device_type(self):
        return self._row[1]

    def start_ns(self):
        return self._row[2]

    def end_ns(self):
        return self._row[3]

    def is_user_annotation(self):
        return self._row[4]


EVENTS = [
    Event("program.forward", CPU, 0, 900, marked=True),
    Event("program.backward", CPU, 900, 2000, marked=True),
    Event("aten::convolution", CPU, 10, 300),
    Event("cudaLaunchKernel", CPU, 20, 40),
    Event("program.forward", CUDA, 100, 1500, marked=True),  # flagged on the card
    Event("program.backward", CUDA, 1500, 3000),  # not flagged: named as its host range
    Event("sm90_xmma_fprop_kernel", CUDA, 100, 400),
    Event("Memcpy DtoD (Device -> Device)", CUDA, 400, 500),
    Event("nccl:all_reduce", CUDA, 1600, 1700),
]


def test_marked_ranges_are_neither_operations_nor_busy_time():
    device, host = trace.split(EVENTS)
    assert sorted(name for _, _, name in device) == [
        "Memcpy DtoD (Device -> Device)", "nccl:all_reduce", "sm90_xmma_fprop_kernel"]
    assert len(host) == 4
    t = trace.Tracer()
    t.device_ops, t.host_ops = sorted(device), host
    assert t.busy_s() == 500 / 1e9
    assert t.work_s() == 400 / 1e9  # the collective left out
    assert t.kernel_time(r"program\.") == (0.0, 0)
